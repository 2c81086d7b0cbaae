"""A test-only entry kind: each request one all-reduce over the ranks,
and a fault that the traffic plants. ``runner.entry_kind`` finds it in
this directory when a test passes the directory among ``kinds``.

The traffic's ``fault`` is ``{"kind": "raise" | "exit" | "stall",
"rank": r (-1: every rank), "request": k}``: request k of the window
raises on rank r after its all-reduce, ends the rank's process with code
17, or sleeps for an hour. The judge gathers every rank's request indices
and reads how many ranks ran other indices than rank 0's, whether rank
0's are 0, 1, 2, ... in turn, and how many all-reduced sums were wrong.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist


class Entry:
    def __init__(self, config, traffic, seed, dev, trace, workers):
        self.dev = dev
        self.fault = traffic.get("fault")
        self.grouped = dist.is_initialized()
        self.rank = dist.get_rank() if self.grouped else 0
        self.world = dist.get_world_size() if self.grouped else 1
        self.in_window = False
        self.seen = []
        self.sums_wrong = 0
        self.latency_ms = []
        self.layer = {"stage_ms": {}, "launches": {}}

    def clear(self):
        self.in_window = True
        self.seen.clear()
        self.latency_ms.clear()
        self.sums_wrong = 0

    def request(self, k):
        t0 = time.perf_counter()
        x = torch.tensor([float(k + 1)], device=self.dev)
        if self.grouped:
            dist.all_reduce(x)
        self.sums_wrong += x.item() != self.world * (k + 1)
        self.seen.append(k)
        self.latency_ms.append((time.perf_counter() - t0) * 1e3)
        f = self.fault
        if (self.in_window and f and k == f["request"]
                and f["rank"] in (self.rank, -1)):
            if f["kind"] == "raise":
                raise RuntimeError(f"planted at request {k}, rank {self.rank}")
            if f["kind"] == "exit":
                os._exit(17)
            if f["kind"] == "stall":
                time.sleep(3600)

    def end_to_end(self, window_s, n):
        return {"solve_ms": window_s * 1e3 / n,
                "solve_ms_p95": float(np.percentile(self.latency_ms, 95))}

    def judge(self, device, limit):
        seen = [self.seen]
        if self.grouped:
            seen = [None] * self.world
            dist.all_gather_object(seen, self.seen)
        return [{"ranks_apart": float(sum(s != self.seen for s in seen)),
                 "out_of_order": float(self.seen
                                       != list(range(len(self.seen)))),
                 "sums_wrong": float(self.sums_wrong),
                 "requests_seen": float(len(self.seen))}]
