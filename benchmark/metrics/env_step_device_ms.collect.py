"""Env step: device ms of a rollout step's env step (the move-success draws
and the DMFB tile kernel), between the CUDA events of a call of the
program's own span `rollout.env_step`
(marl_dmfb_tpu_torch/utils/tracing.py), over the traced rollouts; the
events count the device's idle time inside the span too. Read under the
profiler, which slows the host."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    s = tracing.summary()["spans"].get("rollout.env_step")
    if not s or not s["calls"] or s["device_ms"] is None:
        return None
    return s["device_ms"] / s["calls"]
