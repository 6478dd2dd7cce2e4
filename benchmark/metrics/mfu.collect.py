"""Whole step: the analytic model FLOPs of the window's rollouts (their forwards)
(benchmark/flops.py) over the window's wall time, against the card's
float32 peak (percent)."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx.get("trace") is None:
        return None
    return 100.0 * ctx["window_flops"] / ctx["window_s"] / ctx["peak_flops"]
