"""MoE block: the straggler factor of the held experts, the most (token,
slot) pairs that one held expert got in a MoE layer's dispatch over the
held experts' mean there, averaged over the window's dispatches (the
timer's counters ``moe.load_max_over_mean`` and ``moe.dispatch.calls``,
summed over MoE layers and micro-steps); a grouped product over the held
experts takes as long as its largest group.  None without the counters."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("moe.dispatch.calls"):
        return None
    return c["moe.load_max_over_mean"] / c["moe.dispatch.calls"]
