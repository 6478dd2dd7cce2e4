"""Learner: device kernels launched an update, counted in the profiler
inside the `learn_many` ranges of the traced cycles, over their updates."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or "learn_many" not in t["spans"]:
        return None
    return t["spans"]["learn_many"]["kernels"] / ctx["updates_traced"]
