"""Allocator: cudaMalloc calls of the caching allocator per micro-step of
the window (``StageTimer`` ``mallocs`` of the stages ``forward``,
``backward`` and ``optimizer``: new segments, read over each stage from
``torch.cuda.memory_stats``); None where the timer keeps no ``mallocs``."""

STAGES = ("forward", "backward", "optimizer")


def read(ctx):
    t = ctx.get("timer") or {}
    if not all(k in t and "mallocs" in t[k] for k in STAGES) or not t["forward"]["count"]:
        return None
    return sum(t[k]["mallocs"] for k in STAGES) / t["forward"]["count"]
