"""K1's bf16 design (``csrc/flash_attention_sm90.cu``) on the CPU: a torch
emulation of the kernel's arithmetic held against the Pallas kernel in
interpret mode and against the port's plain version, within the tolerance
``chip_smoke.py`` holds the card's kernel to (one bf16 output rounding,
2^-7 x max|want|; the LSE within 1e-5).  This shows that the one rounding
the design adds, P to bf16 before P V, fits that tolerance.

The emulation follows the kernel step for step: 128-query blocks over
128-key tiles, the tiles past the block's chunk bound and past length[b]
skipped, S from exact bf16 products summed in fp32 and scaled afterwards by
sm_scale * log2(e), -inf past T and -1e30 past the row's limit, a base-2
online softmax in fp32, the row sum l from fp32 P, and O += bf16(P) V in
fp32."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from cosyvoice2_eu_torch.ops import flash_attention as port_fa
from cosyvoice2_eu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

TILE = 128  # the kernel's query block and key tile
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
NEG_INF = -1.0e30


def sm90_emulation(q, k, v, lengths, chunk: int):
    """The bf16 kernel's arithmetic in torch: q, k, v (B, H, T, D) bf16.
    Returns O (B, H, T, D) bf16 and the natural-log LSE (B, H, T) fp32."""
    b, h, n, d = q.shape
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    o = torch.zeros((b, h, n, d), dtype=torch.bfloat16)
    lse = torch.zeros((b, h, n), dtype=torch.float32)
    pad = -n % TILE  # the tensor map reads zeros past T
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    for bi in range(b):
        length = int(lengths[bi])
        for q0 in range(0, n, TILE):
            rows = torch.arange(q0, min(q0 + TILE, n))
            kv_end = n
            if chunk > 0:
                kv_end = min(kv_end, (int(rows[-1]) // chunk + 1) * chunk)
            if length > 0:
                kv_end = min(kv_end, length)
            limit = ((rows // chunk + 1) * chunk).clamp(max=length) if chunk > 0 else \
                torch.full_like(rows, length)
            m = torch.full((h, len(rows)), NEG_INF)
            l = torch.zeros((h, len(rows)))
            acc = torch.zeros((h, len(rows), d))
            for k0 in range(0, -(-kv_end // TILE) * TILE, TILE):
                keys = torch.arange(k0, k0 + TILE)
                s = q[bi, :, rows].float() @ kf[bi, :, k0:k0 + TILE].transpose(-1, -2)
                s = s * scale_log2  # after the exact bf16 products, as the kernel does
                s = torch.where(keys >= limit[:, None], torch.tensor(NEG_INF), s)
                s = torch.where(keys >= n, torch.tensor(-math.inf), s)
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(s - mx[..., None])
                l = l * alpha + p.sum(-1)
                m = mx
                acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[bi, :, k0:k0 + TILE]
            o[bi, :, rows] = (acc / l.clamp(min=1e-30)[..., None]).bfloat16()
            m_nat = torch.where(m == NEG_INF, torch.tensor(NEG_INF), m * LN2)
            lse[bi, :, rows] = m_nat + torch.log(l.clamp(min=1e-30))
    return o, lse


def _bf16_inputs(t_len, seed, b=2, h=2, d=64):
    """q, k, v from a seed, rounded to bf16 (unit normal, as on the card)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, t_len, d)).astype(np.float32)).bfloat16()
            for _ in range(3)]


CASES = [(256, 0, [256, 160]), (256, 64, [256, 100]), (384, 0, [384, 300]), (384, 64, [300, 384])]


@pytest.mark.parametrize("t_len,chunk,lengths", CASES)
def test_sm90_emulation_matches_pallas_interpret(t_len, chunk, lengths):
    """Against the Pallas kernel in interpret mode on the same bf16 values
    (as fp32 arrays), on valid query rows: within 2^-7 x max|want|."""
    q, k, v = _bf16_inputs(t_len, seed=t_len + chunk)
    want = np.asarray(jax_flash(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                                jnp.asarray(lengths), chunk_size=chunk, block_q=128,
                                block_k=128, interpret=True))
    got, _ = sm90_emulation(q, k, v, lengths, chunk)
    got = got.float().numpy()
    for b, n in enumerate(lengths):
        err = np.abs(got[b, :, :n] - want[b, :, :n]).max()
        tol = 2.0 ** -7 * np.abs(want[b, :, :n]).max()
        assert err <= tol, (b, err, tol)


@pytest.mark.parametrize("t_len,chunk,lengths", CASES)
def test_sm90_emulation_matches_plain(t_len, chunk, lengths):
    """Against the port's plain version (bf16 in, fp32 math, bf16 out) on
    every row, pad rows included: O within 2^-7 x max|want|, LSE within 1e-5."""
    q, k, v = _bf16_inputs(t_len, seed=t_len + chunk)
    want_o, want_lse = port_fa.flash_attention_reference(q, k, v, t(lengths), chunk,
                                                         return_lse=True)
    got_o, got_lse = sm90_emulation(q, k, v, lengths, chunk)
    err = (got_o.float() - want_o.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want_o.float().abs().max().item(), err
    assert (got_lse - want_lse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("chunk", [0, 50])
@pytest.mark.parametrize("t_len", [1, 65, 129, 200])
def test_sm90_emulation_at_tile_edges(t_len, chunk):
    """At T around the 128-row tile (a partial tile, one past a tile) against
    the plain version on every row: O within 2^-7 x max|want|, LSE 1e-5."""
    q, k, v = _bf16_inputs(t_len, seed=7 * t_len + chunk)
    lengths = [t_len, max(1, (3 * t_len) // 5)]
    want_o, want_lse = port_fa.flash_attention_reference(q, k, v, t(lengths), chunk,
                                                         return_lse=True)
    got_o, got_lse = sm90_emulation(q, k, v, lengths, chunk)
    err = (got_o.float() - want_o.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want_o.float().abs().max().item(), err
    assert (got_lse - want_lse).abs().max().item() <= 1e-5


def test_sm90_emulation_row_of_length_zero():
    """length 0 at chunk 0: every key is visited and masked alike, so the row
    is the mean of V over all T keys, as in the plain version; its LSE is
    -1e30 + log(T)."""
    q, k, v = _bf16_inputs(200, seed=3)
    lengths = [200, 0]
    want_o, want_lse = port_fa.flash_attention_reference(q, k, v, t(lengths), 0, return_lse=True)
    got_o, got_lse = sm90_emulation(q, k, v, lengths, 0)
    mean = v[1].float().mean(1)
    for got in (got_o[1].float(), want_o[1].float()):
        assert (got - mean[:, None]).abs().max().item() <= 2.0 ** -7 * mean.abs().max().item()
    assert (got_o.float() - want_o.float()).abs().max().item() <= \
        2.0 ** -7 * want_o.float().abs().max().item()
    assert torch.equal(got_lse[1], want_lse[1])


def test_dtype_picks_the_kernel_design():
    """bf16 launches the wgmma/TMA source, fp32 the 3xTF32 mma.sync source."""
    assert port_fa.fwd_kernel(torch.bfloat16) == ("flash_attention_sm90.cu",
                                                  "cosy_flash_attention_sm90_fwd")
    assert port_fa.fwd_kernel(torch.float32) == ("flash_attention.cu", "cosy_flash_attention_fwd")
