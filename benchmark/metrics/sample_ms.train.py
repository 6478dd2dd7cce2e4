"""Replay: host ms of a minibatch's gather from the ring, a call of the
program's own span `learn.sample` (marl_dmfb_tpu_torch/utils/tracing.py),
over the traced cycles. Read under the profiler, which slows the host."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    s = tracing.summary()["spans"].get("learn.sample")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
