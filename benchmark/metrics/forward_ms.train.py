"""Learner: host ms of an update's loss (the eval and target unrolls and the
TD loss), a call of the program's own span `learn.forward`
(marl_dmfb_tpu_torch/utils/tracing.py), over the traced cycles. Read under
the profiler, which slows the host."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    s = tracing.summary()["spans"].get("learn.forward")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
