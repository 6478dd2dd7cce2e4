"""Env step: the DMFB step's least bytes at the cell's batch
(benchmark/flops.py) over the card's HBM rate, as a share of the time a
call of the env's step took, chained between CUDA events (percent)."""


def read(ctx):
    s = ctx.get("step")
    if s is None or s["seconds"] <= 0:
        return None
    return 100.0 * s["bytes"] / s["peak_bytes"] / s["seconds"]
