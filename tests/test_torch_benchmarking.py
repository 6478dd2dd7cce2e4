"""The port's timing helpers (``marl_dmfb_tpu_torch/utils/benchmarking.py``,
JAX ``utils/benchmarking.py``) on the CPU: each returns positive seconds
and the last result, and a host read takes a tree's first tensor."""

import pytest
import torch

from marl_dmfb_tpu_torch.utils import benchmarking as bm


def test_hostread_reads_the_first_tensor():
    tree = {"a": [None, (torch.tensor([3.0, 4.0]), torch.zeros(2))],
            "b": torch.ones(1)}
    assert bm.hostread(tree) == 3.0
    with pytest.raises(ValueError, match="no tensor"):
        bm.hostread({"a": 1})


def test_rtt_and_timers_return_positive_seconds_and_the_result():
    assert bm.measure_rtt("cpu") > 0
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.arange(4.0)
    seconds, out = bm.timeit_dispatch(fn, x, iters=5, warmup=2)
    assert seconds > 0 and len(calls) == 7
    assert torch.equal(out, x * 2)
    seconds, state = bm.timeit_chained(
        lambda i, s: s + i, torch.zeros(3), iters=4, warmup=1,
        subtract_rtt=False)
    assert seconds > 0
    assert torch.equal(state, torch.full((3,), 0.0 + 1 + 2 + 3 + 4))
