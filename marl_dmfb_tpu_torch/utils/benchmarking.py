"""Timing that waits for the device (JAX ``utils/benchmarking.py``).

A CUDA call returns when its kernels are queued, not when they have run.
Every timed region here therefore ends with the device drained, by
``torch.cuda.synchronize`` and a host read of the result (:func:`hostread`),
which cannot come back before the work that produced the value.  Chained
and repeated calls amortize the one round trip at the end, and one round
trip (:func:`measure_rtt`) is subtracted from the total.  On CPU tensors
the same helpers time the host.
"""

from __future__ import annotations

import time

import torch


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (dict, list, tuple)):
        for x in (tree.values() if isinstance(tree, dict) else tree):
            found = _first_tensor(x)
            if found is not None:
                return found
    return None


def hostread(tree) -> float:
    """Drain the device of the first tensor of ``tree`` (a tensor, or
    dicts, lists and tuples of them) and read one of its elements on the
    host."""
    leaf = _first_tensor(tree)
    if leaf is None:
        raise ValueError("hostread: the result holds no tensor")
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.detach().reshape(-1)[0])


def _finish(result) -> None:
    """Wait for the work behind ``result``: a host read of its first
    tensor, or, where it holds none, a drain of the current CUDA device."""
    if _first_tensor(result) is not None:
        hostread(result)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_rtt(device="cuda", iters: int = 5) -> float:
    """Median seconds of a round trip: one small operation on ``device``
    and the host read of its result."""
    x = torch.ones((), device=device)
    hostread(x + x)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        hostread(x + 0.0)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _device_of(tree):
    leaf = _first_tensor(tree)
    if leaf is not None:
        return leaf.device
    return "cuda" if torch.cuda.is_available() else "cpu"


def timeit_dispatch(fn, *args, iters: int = 50, warmup: int = 2,
                    subtract_rtt: bool = True):
    """Seconds per call of ``fn(*args)`` called ``iters`` times back to
    back, ended by one host read of the last result (a drain of the card
    where the result holds no tensor), and that result:
    ``(seconds, last_result)``.  One round trip is subtracted (clamped
    positive)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _finish(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _finish(out)
    total = time.perf_counter() - t0
    rtt = measure_rtt(_device_of(out)) if subtract_rtt else 0.0
    return max(1e-9, total - rtt) / iters, out


def timeit_chained(step, init, iters: int, warmup: int = 1,
                   subtract_rtt: bool = True):
    """Seconds per iteration of ``state = step(i, state)`` chained ``iters``
    times from ``init`` (``i`` counts the calls, warm-up included), ended
    by one host read of the final state, and that state:
    ``(seconds, state)``.  One round trip is subtracted (clamped
    positive)."""
    state = init
    for i in range(warmup):
        state = step(i, state)
    _finish(state)
    t0 = time.perf_counter()
    for i in range(iters):
        state = step(warmup + i, state)
    _finish(state)
    total = time.perf_counter() - t0
    rtt = measure_rtt(_device_of(state)) if subtract_rtt else 0.0
    return max(1e-9, total - rtt) / iters, state
