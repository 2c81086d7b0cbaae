"""A test-only entry kind: ``sharded2d`` with the fault of
``faults_sharded.py`` that the traffic's ``fault`` names planted on
every rank for the entry's life. ``runner.entry_kind`` finds it in this
directory when a test passes the directory among ``kinds``."""

import torch.distributed as dist

from benchmark import faults_sharded, runner


class Entry(runner.entry_kind("sharded2d")):
    def __init__(self, config, traffic, seed, dev, trace, workers):
        self.fault = faults_sharded.plant(traffic["fault"], dist.get_rank())
        self.fault.__enter__()
        super().__init__(config, traffic, seed, dev, trace, workers)
