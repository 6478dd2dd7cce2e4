"""Parallel: device ms of the NCCL kernels an update on rank 0, inside the
`learn_many` ranges of the traced cycles."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or "learn_many" not in t["spans"]:
        return None
    return 1e3 * t["spans"]["learn_many"]["nccl_s"] / ctx["updates_traced"]
