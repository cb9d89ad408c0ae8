"""Flow: ms per flow call of the window (the timer's ``flow`` stage: one
call a batch, 10 Euler steps over the CFG-doubled rows)."""


def read(ctx):
    stage = ctx["timer"].get("flow")
    if not stage or not stage["count"]:
        return None
    return 1e3 * stage["total_s"] / stage["count"]
