"""Spans and recordings around the calls into the program's layers, put on
the instances that the harness built (no file of the program changes).

A :class:`Spans` times each call of a wrapped method when it is on: the
host clock from the call to a synchronise after it, so that the span holds
the device work the call queued.  Off, a wrapper only forwards the call.
While the profiler runs, each call is also a ``record_function`` range
named ``bench.<span>``, which the trace reader attributes kernels and idle
gaps by.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device):
        self.device = torch.device(device)
        self.on = False        # time each call, ended by a synchronise
        self.labels = False    # wrap each call in a profiler range
        self.times = defaultdict(list)   # span -> [seconds]
        self.counts = defaultdict(list)  # span -> [work units]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn, units=None):
        """``fn`` timed as span ``name``; ``units(args, kwargs)`` counts
        the work of a call (default 1)."""
        def call(*args, **kwargs):
            if not (self.on or self.labels):
                return fn(*args, **kwargs)
            if self.labels:
                with torch.profiler.record_function(f"bench.{name}"):
                    out = fn(*args, **kwargs)
                    self.sync()
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                self.times[name].append(time.perf_counter() - t0)
                self.counts[name].append(
                    1 if units is None else units(args, kwargs))
            return out
        return call
