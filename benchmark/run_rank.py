"""One rank of a cell on several cards, started by ``ranks.launch``.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r LOCAL_WORLD_SIZE=n \\
        MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> \\
        python3 benchmark/run_rank.py < job.json

reads the run as JSON on standard input (``ranks.job``) and runs it as
rank r of n (``ranks.rank_main``). Rank 0 prints the result. Whatever
raises ends the process at once with code 1, so that a rank at fault
never waits in a collective or in a teardown.
"""

import json
import os
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark import ranks, runner
    os.environ.update(runner.cache_env(ROOT))
    try:
        rc = ranks.rank_main(json.load(sys.stdin))
    except BaseException:
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
