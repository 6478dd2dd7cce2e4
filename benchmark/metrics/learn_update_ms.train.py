"""Learner: wall ms of an update, over the spans around the trainer's
`learn_many` (each ended by a synchronise) of the measured window."""


def read(ctx):
    s = ctx["spans"].get("learn_many")
    if not s or not sum(s["units"]):
        return None
    return 1e3 * sum(s["seconds"]) / sum(s["units"])
