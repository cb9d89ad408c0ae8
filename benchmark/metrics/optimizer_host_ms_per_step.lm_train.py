"""Optimizer: the host's ms in ``train/optim.py``'s step per micro-step,
accumulating and emitting steps together (``StageTimer`` ``host_s`` of the
stage ``optimizer``: up to its sync, so its enqueue and every wait of the
host inside it); None where the timer keeps no ``host_s``."""


def read(ctx):
    t = (ctx.get("timer") or {}).get("optimizer")
    if not t or not t["count"] or "host_s" not in t:
        return None
    return 1e3 * t["host_s"] / t["count"]
