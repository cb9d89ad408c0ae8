"""Kernels: K1 fp32 (with LSE), K3 and K4 together in the traced cycle:
the sum of every call's bound time (operations and bytes from its shapes,
chunk masks counted, against 3xTF32's 165 TFLOP/s and HBM bandwidth) over
the three kernels' device time in the trace."""

from harness import flops

KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def read(ctx):
    tr, calls = ctx.get("trace"), ctx.get("attn_calls")
    if not tr or not calls:
        return None
    dev_s = sum(s for name, (s, _) in tr["kernels"].items() if any(k in name for k in KERNELS))
    if dev_s <= 0:
        return None
    h, d, bound = ctx["attn_heads"], ctx["attn_head_dim"], 0.0
    for lengths, chunk in calls:
        for ops, nbytes in (flops.attention_fwd(lengths, h, d, 4, chunk, lse=True),
                            flops.attention_dq(lengths, h, d, 4, chunk),
                            flops.attention_dkv(lengths, h, d, 4, chunk)):
            bound += ctx["attn_blocks"] * flops.bound_seconds(ops, nbytes, flops.FP32_FLOPS)
    return 100.0 * bound / dev_s
