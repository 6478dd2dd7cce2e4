"""Replay: wall ms of a store into the ring, over the spans around the
trainer's store (each ended by a synchronise) of the measured window."""


def read(ctx):
    s = ctx["spans"].get("store")
    if not s or not s["seconds"]:
        return None
    return 1e3 * sum(s["seconds"]) / len(s["seconds"])
