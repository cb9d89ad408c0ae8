"""Whole step: model FLOPs of the window's micro-steps (forward and
backward, 3x the forward's, each row at its own length) per second of the
window, as a share of the configuration's peak (fp32: 3xTF32)."""


def read(ctx):
    if not ctx.get("model_flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * ctx["peak_flops"])
