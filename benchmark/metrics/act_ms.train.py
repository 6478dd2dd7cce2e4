"""Agent net: host ms of a rollout step's action (the net's forward, the
argmax, the exploration draws), a call of the program's own span
`rollout.act` (marl_dmfb_tpu_torch/utils/tracing.py), over the traced
cycles. Read under the profiler, which slows the host."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    s = tracing.summary()["spans"].get("rollout.act")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
