"""Train step: ms of the forward and the backward pass (``StageTimer``
stages ``forward`` and ``backward``, synchronised at each end) per
micro-step of the window."""


def read(ctx):
    t = ctx["timer"]
    if "forward" not in t or not t["forward"]["count"]:
        return None
    return 1e3 * (t["forward"]["total_s"] + t["backward"]["total_s"]) / t["forward"]["count"]
