"""The port's own spans and counters, at the boundaries of its layers.

A span names a piece of work where it is done::

    from marl_dmfb_tpu_torch.utils import tracing

    with tracing.span("rollout.env_step"):
        new_states, out = env.step_core(states, a, uniforms)
    tracing.count("rollout.chip_steps", B * T)

Each record holds the span's name, the span that encloses it, the cycle it
belongs to (the spans opened inside one outermost span, e.g. one training
cycle, share it), its host start and end (``time.perf_counter_ns``) and,
where the process uses CUDA, a pair of CUDA events recorded on the current
stream at its start and end.  The events are read only by :func:`summary`,
never while the work runs.  A counter adds host integers known without a
read of the device.

Off is the default.  A span that is off checks a flag and whether a
profiler records: it enters no ``record_function``, creates no event,
synchronises nothing and draws from no generator, so the program's results
are the same bitwise whether tracing is on or off.  Tracing is on

* while a ``torch.profiler`` session records: each span is then also a
  ``record_function`` range named ``marl.<name>`` in the profiler's trace,
  on the clock of the device's kernels, and a new session starts a fresh
  record (a session is told from the last by a span run while no profiler
  records, or by :func:`reset`);
* between :func:`enable` and :func:`disable`, which record every span
  until they are read or reset.

:func:`profile_to` runs a call under the profiler and writes its Chrome
trace and the spans' summary; ``train --profile_dir DIR`` uses it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch
from torch._C._autograd import _profiler_enabled

PREFIX = "marl."   # of the spans' ranges in a profiler trace


class _Record:
    __slots__ = ("name", "parent", "cycle", "start_ns", "end_ns", "events")

    def __init__(self, name, parent, cycle, events):
        self.name, self.parent, self.cycle = name, parent, cycle
        self.events = events
        self.end_ns = None
        self.start_ns = time.perf_counter_ns()


class _Span:
    """One open span of ``tracer``: a record, the events, the range."""

    __slots__ = ("tracer", "name", "record", "range")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        profiling = _profiler_enabled()
        if profiling and not t.profiled and not t.enabled:
            t.reset()   # the first span of a new profiler session
        t.profiled = profiling
        self.range = None
        if profiling:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        if not t.stack:
            t.cycles += 1
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec = _Record(self.name, t.stack[-1] if t.stack else None,
                      t.cycles, events)
        if events is not None:
            events[0].record()
        t.stack.append(rec)
        t.records.append(rec)
        self.record = rec
        return self

    def __exit__(self, *exc):
        rec, stack = self.record, self.tracer.stack
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.perf_counter_ns()
        if stack and stack[-1] is rec:   # (a reset may have dropped it)
            stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


class Tracer:
    """The spans and counters of one process (module docstring); the
    module's functions act on one shared instance, as the profiler they
    follow is one per process."""

    def __init__(self):
        self.enabled = False    # enable() .. disable()
        self.profiled = False   # the last span ran under the profiler
        self.records: list = []
        self.counters: dict = defaultdict(int)
        self.stack: list = []   # the open spans' records
        self.cycles = 0

    def span(self, name: str):
        """A context manager that records ``name`` while tracing is on."""
        if self.enabled or _profiler_enabled():
            return _Span(self, name)
        self.profiled = False
        return _OFF

    def count(self, name: str, n: int):
        """Add ``n`` (a host integer) to counter ``name`` while on."""
        if self.enabled or _profiler_enabled():
            self.counters[name] += n

    def enable(self):
        """Record every span from now on, on a fresh record."""
        self.reset()
        self.enabled = True

    def disable(self):
        """Stop recording; what was recorded stays readable."""
        self.enabled = False

    def reset(self):
        self.records, self.stack = [], []
        self.counters = defaultdict(int)
        self.cycles = 0

    def records_of(self) -> list:
        """The records as dicts (``name``, ``parent``: the index of the
        enclosing span's record in this list or None, ``cycle``,
        ``start_ns``, ``end_ns``: None while the span is open)."""
        index = {id(r): i for i, r in enumerate(self.records)}
        return [{"name": r.name, "parent": index.get(id(r.parent)),
                 "cycle": r.cycle, "start_ns": r.start_ns,
                 "end_ns": r.end_ns} for r in self.records]

    def summary(self) -> dict:
        """Per span name: ``calls``, ``host_ms`` (total), ``self_ms`` (the
        total less its child spans'), ``device_ms`` (between its events,
        None without CUDA); the ``counters``; the number of ``cycles``.
        Waits for the events' work to finish; spans still open are left
        out."""
        done = [r for r in self.records if r.end_ns is not None]
        child_ns = defaultdict(int)
        for r in done:
            if r.parent is not None:
                child_ns[id(r.parent)] += r.end_ns - r.start_ns
        spans = {}
        for r in done:
            s = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                          "self_ms": 0.0, "device_ms": None})
            ns = r.end_ns - r.start_ns
            s["calls"] += 1
            s["host_ms"] += ns / 1e6
            s["self_ms"] += (ns - child_ns[id(r)]) / 1e6
            if r.events is not None:
                r.events[1].synchronize()
                s["device_ms"] = ((s["device_ms"] or 0.0)
                                  + r.events[0].elapsed_time(r.events[1]))
        return {"spans": spans, "counters": dict(self.counters),
                "cycles": len({r.cycle for r in done})}


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
records = TRACER.records_of
summary = TRACER.summary


def profile_to(profile_dir: str, fn, device):
    """``fn()`` under ``torch.profiler`` (the CPU, and CUDA where
    ``device`` is a card), its spans on; writes ``profile_dir/trace.json``
    (a Chrome trace, the ``marl.*`` ranges beside the kernels) and
    ``profile_dir/spans.json`` (:func:`summary`).  Returns ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "spans.json"), "w") as f:
        json.dump(summary(), f, indent=1)
    return out
