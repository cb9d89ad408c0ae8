"""K1's fp32 design in 3xTF32 (``csrc/flash_attention.cu``) on the CPU: a
torch emulation of its sums held against the JAX package's Pallas kernel in
interpret mode (``_flash_call`` with LSE) and against the plain version,
within the tolerances ``chip_smoke.py`` holds the card's kernel to: O within
1e-4 and the LSE within 1e-5, on every row.

The emulation follows the kernel: Q pre-scaled by scale * log2(e) in fp32;
each product split into TF32 hi and lo on the bits (the helpers of
``test_torch_flash_bwd_tf32.py``), taken as lo*hi + hi*lo + hi*hi per 8-deep
k-step, each term one mma rounded once into the fp32 accumulator; a block of
64 query rows over 32-key tiles in order, as many as the kernel visits (the
chunk bound of the block's last row and length[b], when it is above 0); the
mask and the base-2 online softmax on each tile, with the per-tile rescale
of l and the O accumulator; O = acc / max(l, 1e-30) and the natural-log LSE
with the TPU kernel's -1e30 for a row with no visible key."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_bwd_tf32 import _rows, mma3, tf32_rna
from torch_parity import t

from cosyvoice2_eu_torch.ops import flash_attention as port_fa
from cosyvoice2_eu_tpu.ops.pallas.flash_attention import _fit_block, _flash_call

BM, SN = 64, 32  # query rows of a block, keys of a streamed tile (as the source)
NEG_INF = -1.0e30
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)
O_TOL, LSE_TOL = 1e-4, 1e-5


def mma_hi(acc, a, b):
    """acc + a @ b in plain TF32: the hi*hi term alone, per 8-deep k-step."""
    ahi, bhi = tf32_rna(a), tf32_rna(b)
    for k in range(0, a.shape[-1], 8):
        prod = ahi[..., k:k + 8].double() @ bhi[..., k:k + 8, :].double()
        acc = (acc.double() + prod).float()
    return acc


def k1_emulation(q, k, v, length, chunk, scale, product=mma3):
    """(O, LSE) as K1 sums them.  (BH, T, D) fp32 q/k/v, length (BH,)."""
    bh, t_len, d = q.shape
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    o, lse = torch.zeros_like(q), torch.zeros((bh, t_len))
    for q0 in range(0, t_len, BM):
        rows = q0 + torch.arange(BM)
        qs = _rows(q, q0, BM) * scale_log2
        end = length[:, None].expand(-1, BM)
        if chunk > 0:
            end = torch.minimum((rows // chunk + 1)[None] * chunk, end)
        # the key tiles the block visits, per (batch*head)
        kv_end = torch.full((bh,), t_len)
        if chunk > 0:
            kv_end = kv_end.clamp(max=((min(q0 + BM, t_len) - 1) // chunk + 1) * chunk)
        kv_end = torch.where(length > 0, torch.minimum(kv_end, length), kv_end)
        n_tiles = (kv_end + SN - 1) // SN
        acc = torch.zeros((bh, BM, d))
        m = torch.full((bh, BM), NEG_INF)
        l = torch.zeros((bh, BM))
        for kb in range(int(n_tiles.max())):
            keys = kb * SN + torch.arange(SN)
            s = product(torch.zeros((bh, BM, SN)), qs, _rows(k, kb * SN, SN).transpose(1, 2))
            s = torch.where(keys[None, None] < end[..., None], s, NEG_INF)
            s = torch.where(keys[None, None] < t_len, s, -torch.inf)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            acc_new = product(acc * alpha[..., None], p, _rows(v, kb * SN, SN))
            visits = (kb < n_tiles)[:, None]
            l = torch.where(visits, l * alpha + p.sum(-1), l)
            m = torch.where(visits, mx, m)
            acc = torch.where(visits[..., None], acc_new, acc)
        n = min(BM, t_len - q0)
        o[:, q0:q0 + n] = (acc * (1.0 / l.clamp(min=1e-30))[..., None])[:, :n]
        m_nat = torch.where(m == NEG_INF, NEG_INF, m * LN2)
        lse[:, q0:q0 + n] = (m_nat + torch.log(l.clamp(min=1e-30)))[:, :n]
    return o, lse


def _case(t_len, lengths, chunk, seed, product=mma3):
    """The emulated K1 and its two references at one shape: {name: (o, lse)}
    with the emulation under "kernel", all (B, H, T, ...), and v."""
    b, h, d = len(lengths), 2, 64
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t_len, d)).astype(np.float32) for _ in range(3))
    lengths = np.asarray(lengths, np.int32)
    scale = 1.0 / np.sqrt(d)
    block = _fit_block(256, t_len)  # any T up to 256 is one block
    o_jax, lse_jax = _flash_call(
        *(jnp.asarray(x.reshape(b * h, t_len, d)) for x in (q, k, v)),
        jnp.repeat(jnp.asarray(lengths), h), chunk, scale, block, block, interpret=True,
        with_lse=True)
    qt, kt, vt = map(t, (q, k, v))
    plain = port_fa.flash_attention_reference(qt, kt, vt, t(lengths), chunk, return_lse=True)
    flat = [x.reshape(b * h, t_len, d) for x in (qt, kt, vt)]
    o, lse = k1_emulation(*flat, t(lengths).long().repeat_interleave(h), chunk, scale, product)
    return {"kernel": (o.reshape(b, h, t_len, d), lse.reshape(b, h, t_len)),
            "pallas": (t(np.asarray(o_jax)).reshape(b, h, t_len, d),
                       t(np.asarray(lse_jax)).reshape(b, h, t_len)),
            "plain": plain}, vt


def _errors(got):
    """(O error, LSE error) of the emulation against each reference, every row."""
    o, lse = got["kernel"]
    return {ref: ((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
            for ref, (want_o, want_lse) in got.items() if ref != "kernel"}


def test_emulated_tiles_are_the_sources():
    """The emulation's block and tile heights are the kernel's own: the
    forward takes them from the tile product's header, which it includes."""
    from pathlib import Path

    csrc = Path(port_fa.__file__).parent.parent / "csrc"
    assert '#include "tf32_mma.cuh"' in (csrc / port_fa.SOURCE).read_text()
    header = (csrc / "tf32_mma.cuh").read_text()
    assert f"constexpr int BM = {BM};" in header and f"constexpr int SN = {SN};" in header


@pytest.mark.parametrize("chunk", [0, 50])
@pytest.mark.parametrize("t_len", [1, 31, 32, 33, 63, 64, 65, 127, 129])
def test_kernel_sums_match_pallas_and_plain(t_len, chunk):
    """The emulated K1 against the Pallas kernel (interpret mode) and the
    plain version, at T across the 64-row block and 32-key tile edges,
    lengths [T, 3T // 5] (a row of length 0 at T = 1): O within 1e-4 and the
    LSE within 1e-5 on every row, pad rows included."""
    got, _ = _case(t_len, [t_len, (3 * t_len) // 5], chunk, seed=200 + t_len + chunk)
    for ref, (o_err, lse_err) in _errors(got).items():
        assert o_err <= O_TOL and lse_err <= LSE_TOL, (ref, o_err, lse_err)


def test_row_of_length_zero():
    """length 0 at chunk 0: the kernel visits every key tile and masks every
    key alike, so the row is the mean of V over all T keys on both sides,
    and its LSE is -1e30 + log(T), which is -1e30 in fp32."""
    got, v = _case(200, [200, 0], 0, seed=7)
    for ref, (o_err, lse_err) in _errors(got).items():
        assert o_err <= O_TOL and lse_err <= LSE_TOL, (ref, o_err, lse_err)
    o, lse = got["kernel"]
    assert (o[1] - v[1].mean(1, keepdim=True)).abs().max().item() <= O_TOL
    assert torch.equal(lse[1], torch.full_like(lse[1], NEG_INF))


def test_tf32_alone_misses_the_tolerance():
    """The lo terms matter: with the hi*hi product alone (plain TF32) the
    emulation misses the LSE or O tolerance, so the comparisons above would
    catch a kernel that dropped them."""
    got, _ = _case(129, [129, 77], 0, seed=11, product=mma_hi)
    errs = _errors(got)
    assert any(o_err > O_TOL or lse_err > LSE_TOL for o_err, lse_err in errs.values()), errs

