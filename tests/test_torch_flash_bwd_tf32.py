"""K3 and K4's 3xTF32 design (``csrc/flash_attention_bwd.cu``) on the CPU: the
kernels' split of an fp32 operand into TF32 hi and lo parts, and a torch
emulation of their sums held against the JAX package's custom VJP (Pallas
kernels in interpret mode) and against the plain version, within the
tolerance ``chip_smoke.py`` holds the card's kernels to (1e-4 x max(1,
max|want|)).

The emulation follows the kernels: cvt.rna.tf32.f32's rounding done on the
bits (round to nearest, ties away from zero, to 10 mantissa bits); each
product as lo*hi + hi*lo + hi*hi with lo*lo dropped, one m16n8k8 mma per
8-deep k-step and term, each adding its exact products to the fp32
accumulator with one rounding; S and dP over D per tile; the mask, P and dS
in fp32 on the tile; K3 a 64-query block over 32-key tiles from key 0, K4 a
64-key block over 32-query tiles from ``qb_start``, each accumulating across
its tiles in that order.  Tiles past the last one a kernel visits add exact
zeros, so the emulation visits them all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from cosyvoice2_eu_torch.ops import flash_attention as port_fa
from cosyvoice2_eu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

BM, SN = 64, 32  # stationary rows of a block, streamed rows of a tile (as the source)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite fp32: add half of the 13 dropped bits to
    the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma3(acc, a, b):
    """acc + a @ b as the kernels take it: per 8-deep k-step, the terms
    lo*hi, hi*lo and hi*hi, each one mma rounded once into fp32."""
    (ahi, alo), (bhi, blo) = split(a), split(b)
    for k in range(0, a.shape[-1], 8):
        for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
            prod = x[..., k:k + 8].double() @ y[..., k:k + 8, :].double()
            acc = (acc.double() + prod).float()
    return acc


def _rows(x, r0, n):
    """Rows r0 .. r0+n-1 of (BH, T, ...) x, zeros past T (the kernels' zero fill)."""
    out = torch.zeros((x.shape[0], n, *x.shape[2:]), dtype=x.dtype)
    part = x[:, r0:r0 + n]
    out[:, :part.shape[1]] = part
    return out


def _visible_end(rows, chunk, length, t_len):
    """First key past what each row sees (0 for rows at or past T): (BH, n)."""
    end = length[:, None].expand(-1, rows.shape[0])
    if chunk > 0:
        end = torch.minimum((rows // chunk + 1)[None] * chunk, end)
    return torch.where(rows[None] < t_len, end, 0)


def k3_emulation(q, k, v, do, lse, delta, length, chunk, scale):
    """dQ as K3 sums it.  (BH, T, D) fp32 inputs, lse/delta (BH, T), length (BH,)."""
    bh, t_len, d = q.shape
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    dq = torch.zeros_like(q)
    for q0 in range(0, t_len, BM):
        rows = q0 + torch.arange(BM)
        qs, dos = _rows(q, q0, BM), _rows(do, q0, BM)
        end = _visible_end(rows, chunk, length, t_len)
        lse2 = _rows(lse, q0, BM) * LOG2E
        dlt = _rows(delta, q0, BM)
        acc = torch.zeros((bh, BM, d))
        for k0 in range(0, t_len, SN):
            ks, vs = _rows(k, k0, SN), _rows(v, k0, SN)
            s = mma3(torch.zeros((bh, BM, SN)), qs, ks.transpose(1, 2))
            dp = mma3(torch.zeros((bh, BM, SN)), dos, vs.transpose(1, 2))
            keys = k0 + torch.arange(SN)
            visible = keys[None, None, :] < end[:, :, None]
            p = torch.where(visible, torch.exp2(s * scale_log2 - lse2[..., None]), 0.0)
            acc = mma3(acc, p * (dp - dlt[..., None]), ks)
        dq[:, q0:q0 + BM] = (acc * scale)[:, :t_len - q0]
    return dq


def k4_emulation(q, k, v, do, lse, delta, length, chunk, scale):
    """(dK, dV) as K4 sums them; arguments as ``k3_emulation``."""
    bh, t_len, d = q.shape
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, t_len, BM):
        keys = k0 + torch.arange(BM)
        ks, vs = _rows(k, k0, BM), _rows(v, k0, BM)
        dk_acc, dv_acc = torch.zeros((bh, BM, d)), torch.zeros((bh, BM, d))
        qb_start = ((k0 // chunk) * chunk) // SN if chunk > 0 else 0
        for q0 in range(qb_start * SN, t_len, SN):
            rows = q0 + torch.arange(SN)
            qs, dos = _rows(q, q0, SN), _rows(do, q0, SN)
            end = _visible_end(rows, chunk, length, t_len)
            lse2 = _rows(lse, q0, SN) * LOG2E
            dlt = _rows(delta, q0, SN)
            st = mma3(torch.zeros((bh, BM, SN)), ks, qs.transpose(1, 2))
            dpt = mma3(torch.zeros((bh, BM, SN)), vs, dos.transpose(1, 2))
            visible = keys[None, :, None] < end[:, None, :]
            p = torch.where(visible, torch.exp2(st * scale_log2 - lse2[:, None, :]), 0.0)
            dv_acc = mma3(dv_acc, p, dos)
            dk_acc = mma3(dk_acc, p * (dpt - dlt[:, None, :]), qs)
        dk[:, k0:k0 + BM] = (dk_acc * scale)[:, :t_len - k0]
        dv[:, k0:k0 + BM] = dv_acc[:, :t_len - k0]
    return dk, dv


def test_emulated_tiles_are_the_sources():
    """The emulation's block and tile heights are the kernels' own: the
    backward takes them from the tile product's header, which it includes."""
    from pathlib import Path

    csrc = Path(port_fa.__file__).parent.parent / "csrc"
    assert '#include "tf32_mma.cuh"' in (csrc / port_fa.BWD_SOURCE).read_text()
    src = (csrc / "tf32_mma.cuh").read_text()
    assert f"constexpr int BM = {BM};" in src and f"constexpr int SN = {SN};" in src


def test_tf32_split_reproduces_x():
    """hi and lo are TF32 (13 low bits clear); hi is x to nearest at 11
    significant bits; hi + lo reproduces x to 2^-22 relative; bf16 values
    split exactly (lo = 0), as bf16 inputs widened to fp32 do."""
    rng = np.random.default_rng(0)
    n = 200_000
    x = torch.tensor((rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    assert ((xd - hi.double()).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((xd - hi.double() - lo.double()).abs() <= 2.0 ** -22 * xd.abs()).all()
    b = x.to(torch.bfloat16).float()
    bhi, blo = split(b)
    assert torch.equal(bhi, b) and not blo.any()


def test_tf32_rounding_ties_away_from_zero():
    """cvt.rna: a tie rounds the magnitude up, for either sign; below the tie
    it rounds down; a carry out of the mantissa raises the exponent."""
    def f(bits):
        return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32)

    got = tf32_rna(f([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000, 0x3FFFF000]))
    want = f([0x3F802000, 0xBF802000, 0x3F800000, 0x3F804000, 0x40000000])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("chunk", [0, 50])
@pytest.mark.parametrize("t_len", [1, 63, 64, 65, 127, 129])
def test_kernel_sums_match_pallas_and_plain(t_len, chunk):
    """The emulated K3 and K4 against the JAX custom VJP (Pallas backward
    kernels in interpret mode) and against ``flash_attention_bwd_plain`` on
    the same LSE and delta, every row and key, at T across the 64-row block
    and 32-row tile edges; lengths [T, 3T // 5] (a row of length 0 at T = 1).
    dK = dV = 0 exactly past each length.  fp32: 1e-4 x max(1, max|want|)."""
    b, h, d = 2, 2, 64
    rng = np.random.default_rng(100 + t_len + chunk)
    q, k, v, do = (rng.standard_normal((b, h, t_len, d)).astype(np.float32) for _ in range(4))
    lengths = np.asarray([t_len, (3 * t_len) // 5], np.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, jnp.asarray(lengths), chunk_size=chunk,
                                               interpret=True), *map(jnp.asarray, (q, k, v)))
    want_jax = [t(np.asarray(g)) for g in vjp(jnp.asarray(do))]

    qt, kt, vt, dot = map(t, (q, k, v, do))
    o, lse = port_fa.flash_attention_reference(qt, kt, vt, t(lengths), chunk, return_lse=True)
    delta = (dot * o).sum(-1)
    want_plain = port_fa.flash_attention_bwd_plain(qt, kt, vt, dot, lse, delta, t(lengths), chunk)

    scale = 1.0 / np.sqrt(d)
    flat = [x.reshape(b * h, t_len, -1) for x in (qt, kt, vt, dot)]
    rows = [x.reshape(b * h, t_len) for x in (lse, delta)]
    length_bh = t(lengths).long().repeat_interleave(h)
    dq = k3_emulation(*flat, *rows, length_bh, chunk, scale)
    dk, dv = k4_emulation(*flat, *rows, length_bh, chunk, scale)
    got = [x.reshape(b, h, t_len, d) for x in (dq, dk, dv)]

    for ref, want in (("pallas", want_jax), ("plain", want_plain)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            tol = 1e-4 * max(1.0, w.abs().max().item())
            err = (g - w).abs().max().item()
            assert err <= tol, (ref, name, err, tol)
    for i, n in enumerate(lengths):
        assert not got[1][i, :, n:].any() and not got[2][i, :, n:].any()
