"""Device: the share of the traced window in which no kernel ran, over
traced rollouts (percent)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
