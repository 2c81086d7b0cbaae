"""Milliseconds a request of the device's collective kernels (those
named ``nccl``) on the slowest card: each card's seconds of them in the
traced window over the requests, the largest over the ranks
(``record["ranks"]``; one card's own where there is one). It holds the
engine's column sums and row gathers, and the harness's one all-reduce
of a request (``benchmark/ranks.py``), which is small beside them."""


def read(record):
    if record["requests"] <= 0:
        return None
    summaries = [r["summary"] for r in record.get("ranks", [])] or [
        record["summary"]]
    seconds = max(s.seconds_of("nccl")[0] for s in summaries)
    if seconds <= 0:
        return None
    return 1e3 * seconds / record["requests"]
