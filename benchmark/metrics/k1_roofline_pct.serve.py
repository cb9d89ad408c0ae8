"""Kernels: K1 bf16's share of its roofline in the traced batch: the sum of
each call's bound time (operations and bytes from its shapes, against the
bf16 peak and HBM bandwidth) over K1's device time in the trace
(``flash_fwd_sm90``)."""

from harness import flops

KERNEL = "flash_fwd_sm90"


def read(ctx):
    tr, calls = ctx.get("trace"), ctx.get("k1_calls")
    if not tr or not calls:
        return None
    dev_s = sum(s for name, (s, _) in tr["kernels"].items() if KERNEL in name)
    if dev_s <= 0:
        return None
    bound = 0.0
    for lengths in calls:
        ops, nbytes = flops.attention_fwd(lengths, ctx["k1_heads"], ctx["k1_head_dim"],
                                          ctx["k1_elt"])
        bound += flops.bound_seconds(ops, nbytes, flops.BF16_FLOPS)
    return 100.0 * bound / dev_s
