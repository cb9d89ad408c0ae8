"""Device: the share of the traced window in which no operation ran on the
card (100 minus the busy union of its device events)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
