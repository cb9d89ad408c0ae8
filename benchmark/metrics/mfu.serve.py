"""Whole step: the model FLOPs of the window's requests (LM prefill and
decode of each row's own tokens, its flow call, its HiFT; counted from
shapes, padding not counted) per second of the window, as a share of the
bf16 peak."""


def read(ctx):
    if not ctx.get("model_flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * ctx["peak_flops"])
