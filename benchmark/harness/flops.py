"""Peaks of the card, and the operations and bytes that the work needs.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (the port's
``chip_smoke.py`` constants).  fp32 work is held to 3xTF32, a third of the
TF32 peak: the fastest fp32-accurate way on this card, so that no exact
fp32 path can read above 100%.

Counts, from shapes alone: inputs read once, outputs written once, masked
(query, key) pairs not counted.  ``pairs`` gives the unmasked pairs of one
row of a length under the estimator's masks (full over the valid keys, or
chunk-causal).  Model FLOPs of the LM are 2 x its non-embedding parameters
a token plus attention; the flow and HiFT are counted by running the
reference under ``torch.utils.flop_counter`` on the meta device, at each
row's own length, so padding is not counted.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = TF32_FLOPS / 3  # 3xTF32
HBM_BYTES_S = 3.35e12
PEAK = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}


def pairs(length: int, chunk: int = 0) -> int:
    """Unmasked (query, key) pairs of one row of ``length`` valid positions:
    every valid query sees every valid key, or (``chunk`` > 0) the keys up
    to the end of its own chunk."""
    if chunk <= 0:
        return length * length
    full, rest = divmod(length, chunk)
    return chunk * chunk * full * (full + 1) // 2 + rest * length


def attention_fwd(lengths, heads: int, head_dim: int, elt: int, chunk: int = 0,
                  lse: bool = False) -> tuple:
    """(operations, bytes) of one K1 call: S = QK^T and O = PV (2 x 2
    operations a pair and feature); Q, K, V read and O written for the valid
    rows, the LSE written when asked for."""
    ops = sum(4 * heads * head_dim * pairs(n, chunk) for n in lengths)
    rows = sum(lengths) * heads
    nbytes = 4 * rows * head_dim * elt + (4 * rows if lse else 0)
    return ops, nbytes


def attention_dq(lengths, heads: int, head_dim: int, elt: int, chunk: int = 0) -> tuple:
    """(operations, bytes) of one K3 call: S recomputed, dP = dO V^T, dQ =
    dS K (3 products); Q, K, V, dO, the LSE and delta read, dQ written."""
    ops = sum(6 * heads * head_dim * pairs(n, chunk) for n in lengths)
    rows = sum(lengths) * heads
    return ops, 5 * rows * head_dim * elt + 2 * 4 * rows


def attention_dkv(lengths, heads: int, head_dim: int, elt: int, chunk: int = 0) -> tuple:
    """(operations, bytes) of one K4 call: S recomputed, dV = P^T dO, dP =
    dO V^T, dK = dS^T Q (4 products); Q, K, V, dO, the LSE and delta read,
    dK and dV written."""
    ops = sum(8 * heads * head_dim * pairs(n, chunk) for n in lengths)
    rows = sum(lengths) * heads
    return ops, 6 * rows * head_dim * elt + 2 * 4 * rows


def bound_seconds(ops: float, nbytes: float, flops_peak: float) -> float:
    """The least time of a call: the larger of its compute and memory bounds."""
    return max(ops / flops_peak, nbytes / HBM_BYTES_S)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def lm_dense_params(c) -> int:
    """The speech LM's parameters outside its embeddings: the backbone's
    layers and the speech head."""
    b = c.backbone
    h, q, kv = b.hidden_size, b.num_heads * b.head_dim, b.num_kv_heads * b.head_dim
    per_layer = h * (q + 2 * kv) + q * h + 3 * h * b.intermediate_size
    if b.attention_bias:
        per_layer += q + 2 * kv
    return b.num_layers * per_layer + h * (c.speech_token_size + 3) + (c.speech_token_size + 3)


def lm_forward_flops(c, context_lengths) -> float:
    """Forward FLOPs of the LM over tokens whose attention context lengths
    (the positions each token sees, itself included) are given."""
    b = c.backbone
    n = lm_dense_params(c)
    attn = 4 * b.num_layers * b.num_heads * b.head_dim
    return sum(2 * n + attn * ctx for ctx in context_lengths)


def lm_sequence_flops(c, length: int) -> float:
    """Forward FLOPs of one causal sequence of ``length`` tokens."""
    return lm_forward_flops(c, range(1, length + 1))


def meta_flops(fn) -> float:
    """FLOPs that ``fn()`` runs, counted by ``torch.utils.flop_counter``; give
    it inputs on the meta device and nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def quadratic(f, xs=(64, 128, 192)):
    """The quadratic through f at three points, as a function: exact for a
    count that is a polynomial of degree two or less in x."""
    import numpy as np

    ys = [f(x) for x in xs]
    coef = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 2)
    return lambda x: float(np.polyval(coef, float(x)))


class FlowFlops:
    """Model FLOPs of the flow and HiFT of a configuration (``reference.config``
    namespaces), counted on the meta device with the reference, one row at
    its own length: ``encoder(tokens)``, ``estimator(frames)`` (one pass,
    dense attention over the frames), ``hift(frames)``; ``synthesis(tokens)``
    is a flow call: the encoder, then ``n_timesteps`` estimator passes over
    the two CFG rows."""

    def __init__(self, c):
        import torch

        from reference import encoder, estimator, hift, weights
        from reference.layers import tree_map

        meta = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                        {"flow": weights.flow(c.flow), "hift": weights.hift(c.hift)})
        z = lambda *shape: torch.zeros(*shape, device="meta")  # noqa: E731
        fl, hc = c.flow, c.hift
        self.ratio, self.steps = fl.token_mel_ratio, fl.cfm.n_timesteps

        def enc(n):
            return meta_flops(lambda: encoder.upsample_conformer_forward(
                meta["flow"]["encoder"], fl.encoder, z((1, n, fl.input_size)),
                torch.full((1,), n, device="meta")))

        def est(t):
            m = fl.output_size
            return meta_flops(lambda: estimator.estimator_forward(
                meta["flow"]["estimator"], fl.estimator, z((1, m, t)), z((1, 1, t)),
                z((1, m, t)), z((1,)), z((1, m)), z((1, m, t))))

        def voc(t):
            def run():
                mel = z((1, hc.in_channels, t))
                hift.f0_predict(meta["hift"]["f0_predictor"], hc, mel)
                hift.hift_decode(meta["hift"], hc, mel, z((1, 1, t * hc.upsample_scale)))
            return meta_flops(run)

        self.encoder, self.estimator, self.hift = quadratic(enc), quadratic(est), quadratic(voc)

    def synthesis(self, tokens: int) -> float:
        return self.encoder(tokens) + self.steps * 2 * self.estimator(tokens * self.ratio)
