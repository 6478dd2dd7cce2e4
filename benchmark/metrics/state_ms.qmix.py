"""Rollout: host ms of a global state's computation (`env.global_state`,
the boards of droplet and destination ids the mixer reads), a call of the
program's own span `rollout.state` (marl_dmfb_tpu_torch/utils/tracing.py),
over the traced cycles; T + 1 calls a rollout. Read under the profiler,
which slows the host."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    s = tracing.summary()["spans"].get("rollout.state")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
