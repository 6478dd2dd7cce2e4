"""Rollout: wall ms of a training rollout, over the spans around the
trainer's rollout (each ended by a synchronise) of the measured window."""


def read(ctx):
    s = ctx["spans"].get("rollout")
    if not s or not s["seconds"]:
        return None
    return 1e3 * sum(s["seconds"]) / len(s["seconds"])
