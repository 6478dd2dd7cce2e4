"""Mixer: the mixer's forward FLOPs over the traced cycles (the rows of
the program's counter `learn.mix.rows` times a row's FLOPs,
benchmark/flops_qmix.py) at the card's float32 peak, as a share of the
device time of the program's span `learn.mix` around them (percent). At
the configuration's 12,800-wide state the FLOPs bound the mixer: its
float32 states read once take under a third of that time at 3.35 TB/s."""


def read(ctx):
    if ctx.get("trace") is None or "mix_row_flops" not in ctx:
        return None
    try:
        from marl_dmfb_tpu_torch.utils import tracing
    except ImportError:   # a program without spans of its own
        return None
    summary = tracing.summary()
    s = summary["spans"].get("learn.mix")
    rows = summary["counters"].get("learn.mix.rows", 0)
    if not s or not rows or not s["device_ms"]:
        return None
    least_s = rows * ctx["mix_row_flops"] / ctx["peak_flops"]
    return 100.0 * least_s / (s["device_ms"] / 1e3)
