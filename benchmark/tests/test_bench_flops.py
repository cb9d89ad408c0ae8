"""The roofline and model-FLOP arithmetic against counts worked by hand at
small shapes."""

from __future__ import annotations

import json

import pytest
import torch

from harness import flops
from reference import encoder, estimator
from reference import layers as ref_layers
from reference import weights
from reference.config import model_config
from reference.layers import tree_map


def test_pairs_full_and_chunked():
    assert flops.pairs(5) == 25
    assert flops.pairs(5, 2) == 2 + 2 + 4 + 4 + 5
    for n, c in [(1, 50), (50, 50), (173, 50), (7, 3)]:
        assert flops.pairs(n, c) == sum(min(n, (q // c + 1) * c) for q in range(n))


def test_attention_counts_by_hand():
    # K1 bf16, rows of 3 and 5, 2 heads of 4: S and PV, 2 x 2 x 4 a pair and head
    assert flops.attention_fwd([3, 5], 2, 4, 2) == (4 * 2 * 4 * (9 + 25), 4 * 16 * 4 * 2)
    # K1 fp32 with the LSE written: 16 rows x 4 bytes more
    assert flops.attention_fwd([3, 5], 2, 4, 4, lse=True) == (1088, 4 * 16 * 4 * 4 + 64)
    # K3: 3 products; Q, K, V, dO read, dQ written; LSE and delta read
    assert flops.attention_dq([5], 1, 4, 4) == (6 * 4 * 25, 5 * 5 * 4 * 4 + 2 * 4 * 5)
    # K4: 4 products; dK and dV written
    assert flops.attention_dkv([5], 1, 4, 4) == (8 * 4 * 25, 6 * 5 * 4 * 4 + 2 * 4 * 5)
    # a chunk mask counts only the pairs it leaves
    assert flops.attention_fwd([5], 1, 4, 2, chunk=2)[0] == 4 * 4 * 17


def test_bound_is_the_larger_of_compute_and_memory():
    assert flops.bound_seconds(989e12, 0, flops.BF16_FLOPS) == pytest.approx(1.0)
    assert flops.bound_seconds(1, 3.35e12, flops.BF16_FLOPS) == pytest.approx(1.0)
    assert flops.FP32_FLOPS == pytest.approx(165e12)


def _tiny():
    from cosyvoice2_eu_torch.config import config_to_dict, tiny_test_config

    return model_config(json.loads(json.dumps(config_to_dict(tiny_test_config()))))


def test_lm_flops_by_hand():
    c = _tiny()
    # per layer: q, k, v (64 -> 64, 32, 32 with bias), o (64 -> 64), MLP 3 x 64 x 128
    layer = 64 * (64 + 2 * 32) + (64 + 2 * 32) + 64 * 64 + 3 * 64 * 128
    assert flops.lm_dense_params(c.llm) == 2 * layer + 64 * 84 + 84
    attn = 4 * 2 * 4 * 16  # layers x heads x head_dim, 4 a context position
    assert flops.lm_sequence_flops(c.llm, 3) == 3 * 2 * (2 * layer + 64 * 84 + 84) + attn * 6


def test_meta_counts_by_hand():
    x, w = torch.zeros((3, 5), device="meta"), torch.zeros((7, 5), device="meta")
    assert flops.meta_flops(lambda: ref_layers.dense({"weight": w}, x)) == 2 * 3 * 5 * 7
    xc, wc = torch.zeros((1, 2, 10), device="meta"), torch.zeros((4, 2, 3), device="meta")
    assert flops.meta_flops(lambda: ref_layers.conv1d({"weight": wc}, xc)) == 2 * 4 * 2 * 3 * 8


def test_flow_counts_are_exact_quadratics():
    c = _tiny()
    count = flops.FlowFlops(c)
    meta = tree_map(lambda s: torch.empty(s.shape, device="meta"), weights.flow(c.flow))
    fl = c.flow
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    for n in (40, 301):
        direct = flops.meta_flops(lambda: encoder.upsample_conformer_forward(
            meta["encoder"], fl.encoder, z((1, n, fl.input_size)),
            torch.full((1,), n, device="meta")))
        assert count.encoder(n) == pytest.approx(direct, rel=1e-9)
        m = fl.output_size
        direct = flops.meta_flops(lambda: estimator.estimator_forward(
            meta["estimator"], fl.estimator, z((1, m, n)), z((1, 1, n)), z((1, m, n)), z((1,)),
            z((1, m)), z((1, m, n))))
        assert count.estimator(n) == pytest.approx(direct, rel=1e-9)
    assert count.synthesis(50) == pytest.approx(
        count.encoder(50) + fl.cfm.n_timesteps * 2 * count.estimator(100))
