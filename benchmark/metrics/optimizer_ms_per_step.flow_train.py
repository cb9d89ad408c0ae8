"""Optimizer: ms of ``train/optim.py``'s step (``StageTimer`` stage
``optimizer``) per micro-step, accumulating and emitting steps together."""


def read(ctx):
    t = ctx["timer"].get("optimizer")
    if not t or not t["count"]:
        return None
    return 1e3 * t["total_s"] / t["count"]
