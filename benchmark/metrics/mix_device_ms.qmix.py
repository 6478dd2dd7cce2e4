"""Mixer: device ms of an update's two mixer calls (the eval mix, with its
hyper layers over the global states, and the target mix), between the
CUDA events of a call of the program's own span `learn.mix`
(marl_dmfb_tpu_torch/utils/tracing.py), over the traced cycles; one call
an update. The backward of the eval mix runs in `learn.backward`, outside
it."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    s = tracing.summary()["spans"].get("learn.mix")
    if not s or not s["calls"] or s["device_ms"] is None:
        return None
    return s["device_ms"] / s["calls"]
