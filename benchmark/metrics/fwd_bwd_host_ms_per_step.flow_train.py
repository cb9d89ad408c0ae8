"""Train step: the host's ms in the forward and the backward pass per
micro-step of the window (``StageTimer`` ``host_s`` of the stages
``forward`` and ``backward``: each stage up to its sync, which under the
synced timer is its enqueue); None where the timer keeps no ``host_s``."""


def read(ctx):
    t = ctx.get("timer") or {}
    f, b = t.get("forward"), t.get("backward")
    if not f or not b or not f["count"] or "host_s" not in f:
        return None
    return 1e3 * (f["host_s"] + b["host_s"]) / f["count"]
