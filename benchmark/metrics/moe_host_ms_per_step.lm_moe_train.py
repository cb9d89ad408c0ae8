"""MoE block: the host's ms in the MoE blocks' forward and backward per
micro-step of the window (``StageTimer`` ``host_s`` of the stages ``moe``
and ``moe_backward``: under the synced timer each stage's enqueue, with
the dispatch's read of the held experts' sizes); None where the step has
no such stages."""


def read(ctx):
    t = ctx.get("timer") or {}
    f, m, mb = t.get("forward"), t.get("moe"), t.get("moe_backward")
    if not f or not m or not mb or not f["count"] or "host_s" not in m:
        return None
    return 1e3 * (m["host_s"] + mb["host_s"]) / f["count"]
