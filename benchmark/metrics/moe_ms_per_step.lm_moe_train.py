"""MoE block: ms of the MoE blocks' forward and backward (``StageTimer``
stages ``moe`` and ``moe_backward``, nested in ``forward`` and
``backward``, synchronised at each end) per micro-step of the window; None
where the step has no such stages."""


def read(ctx):
    t = ctx.get("timer") or {}
    f, m, mb = t.get("forward"), t.get("moe"), t.get("moe_backward")
    if not f or not m or not mb or not f["count"]:
        return None
    return 1e3 * (m["total_s"] + mb["total_s"]) / f["count"]
