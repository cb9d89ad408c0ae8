"""K2's tensor-core design (``csrc/int8_matmul_sm90.cu``) on the CPU: the
routing between K2's two designs, the kernel's int8 -> bf16 conversion over
all 256 codes, the K splits, and a torch emulation of the kernel's
arithmetic held against the Pallas kernel in interpret mode within the
tolerance ``chip_smoke.py`` holds the card's kernel to (3e-5 x max|want|).

The emulation follows the kernel: K in 64-wide tiles read as zeros past K,
cut into the splits ``sm90_config`` gives; within a split one fp32
accumulator per output, to which every 16-wide k-step (one wgmma) adds its
exact bf16 x int8 products; split 0 is the output, and the other splits are
added to it in order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import t

from cosyvoice2_eu_torch.ops import int8_matmul as port_i8
from cosyvoice2_eu_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul

SM90, FMA = port_i8.SM90_SOURCE, port_i8.SOURCE


@pytest.mark.parametrize("dtype,m,k,aligned,want", [
    (torch.bfloat16, 128, 896, True, SM90),    # one request's prefill
    (torch.bfloat16, 512, 4864, True, SM90),   # a batch of four, the down projection
    (torch.bfloat16, 9, 896, True, SM90),      # one row past the decode tile
    (torch.bfloat16, 80, 80, True, SM90),      # K % 64 != 0 but K % 16 == 0: TMA pads with zeros
    (torch.bfloat16, 8, 896, True, FMA),       # the decode tile
    (torch.bfloat16, 1, 4864, True, FMA),      # decode of one request
    (torch.bfloat16, 4, 896, True, FMA),       # decode of a batch of four
    (torch.float32, 128, 896, True, FMA),      # fp32 x: exact fp32 products, no TF32
    (torch.float32, 512, 4864, True, FMA),
    (torch.bfloat16, 128, 100, True, FMA),     # ragged K: the byte-load path
    (torch.bfloat16, 128, 104, True, FMA),     # K % 16 == 8: a TMA row stride of 208 bytes
    (torch.bfloat16, 128, 896, False, FMA),    # a base off 16 bytes: TMA cannot read it
])
def test_design_routes_by_dtype_rows_k_and_alignment(dtype, m, k, aligned, want):
    """One design per launch, picked before it from dtype, M, K and alignment."""
    assert port_i8.design(dtype, m, k, aligned) == want


# the grid (channel tiles, row tiles, K splits) of each prefill shape, as
# csrc/int8_matmul_sm90.cu's note states it
PREFILL_GRIDS = {
    (128, 896, 896): (14, 1, 4), (128, 128, 896): (2, 1, 4), (128, 4864, 896): (76, 1, 1),
    (128, 896, 4864): (14, 1, 13), (512, 896, 896): (14, 4, 4), (512, 128, 896): (2, 4, 4),
    (512, 4864, 896): (76, 4, 1), (512, 896, 4864): (14, 4, 4),
}


def test_sm90_config_cuts_k_into_nonempty_runs():
    """64-row tiles up to M = 64, else 128; every split holds at least one K
    tile and the runs cover K exactly; no split when the output tiles fill
    half the 132 SMs; the prefill shapes get the grids of the source's note."""
    for m in (9, 17, 64, 65, 128, 130, 257, 512, 1024):
        for n in (33, 128, 896, 4864, 6564):
            for k in (16, 80, 896, 4864):
                rows, s = port_i8.sm90_config(m, n, k)
                assert rows == (64 if m <= 64 else 128)
                k_tiles = -(-k // 64)
                per = -(-k_tiles // s)
                assert 1 <= s <= k_tiles and (s - 1) * per < k_tiles <= s * per, (m, n, k, s)
                if 2 * -(-n // 64) * -(-m // rows) >= port_i8.SM_COUNT:
                    assert s == 1
                if s > 1:
                    assert per >= port_i8.MIN_SPLIT_TILES
    for (m, n, k), grid in PREFILL_GRIDS.items():
        rows, s = port_i8.sm90_config(m, n, k)
        assert (-(-n // 64), -(-m // rows), s) == grid


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the eight bytes (y << 32) | x."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        b = np.uint64((sel >> (4 * i)) & 7)
        out |= ((src >> (np.uint64(8) * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _f32_to_bf16_bits(f):
    """Round to nearest even, as the bf16x2 subtraction rounds its result."""
    b = f.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)
            ).astype(np.uint16)


def i8x2_to_bf16x2(words, half: int):
    """The kernel's ``i8x2_to_bf16x2`` on uint32 words: bytes 2 half and
    2 half + 1 of each word -> (low, high) bf16 bit patterns."""
    b = _byte_perm(words, np.zeros_like(words), 0x4342 if half else 0x4140)
    lo = (b & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    hi = (b & np.uint32(0x00800080)) | np.uint32(0x43004300)
    out = []
    for shift in (0, 16):  # the two bf16 lanes of the subtraction
        a = _bf16_bits_to_f32((lo >> np.uint32(shift)) & np.uint32(0xFFFF))
        c = _bf16_bits_to_f32((hi >> np.uint32(shift)) & np.uint32(0xFFFF))
        out.append(_f32_to_bf16_bits(a - c))  # the fp32 difference is exact
    return out


def test_int8_to_bf16_conversion_exact_for_all_codes():
    """All 256 byte values, each at all four byte positions of a word: the
    bf16 the kernel makes equals float(w) bit for bit."""
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    for shift in range(4):  # every code at every byte position
        words = np.roll(codes, shift).view(np.uint32)
        got = np.empty(256, np.uint16)
        for half in (0, 1):
            lo, hi = i8x2_to_bf16x2(words, half)
            got[2 * half::4], got[2 * half + 1::4] = lo, hi
        want = np.roll(codes, shift).astype(np.float32).view(np.uint32) >> np.uint32(16)
        assert (np.roll(codes, shift).astype(np.float32).view(np.uint32) & 0xFFFF == 0).all()
        np.testing.assert_array_equal(got, want.astype(np.uint16))


def sm90_emulation(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The wgmma design's arithmetic: x (M, K) bf16, w_q (N, K) int8 -> (M, N) fp32."""
    (m, k), n = x.shape, w_q.shape[0]
    _, splits = port_i8.sm90_config(m, n, k)
    k_tiles = -(-k // 64)
    per = -(-k_tiles // splits)
    pad = k_tiles * 64 - k
    codes = w_q.numpy().reshape(-1).view(np.uint32)  # K % 16 == 0: whole words per row
    lo0, hi0 = i8x2_to_bf16x2(codes, 0)
    lo1, hi1 = i8x2_to_bf16x2(codes, 1)
    w_bits = np.stack([lo0, hi0, lo1, hi1], -1).reshape(n, k)
    w = F.pad(torch.from_numpy(_bf16_bits_to_f32(w_bits)), (0, pad))
    xf = F.pad(x.float(), (0, pad))
    y = None
    for z in range(splits):
        acc = torch.zeros((n, m))  # y^T: the accumulator's layout
        for kt in range(z * per, min(k_tiles, (z + 1) * per)):
            for kk in range(4):
                k0 = 64 * kt + 16 * kk
                acc = acc + w[:, k0:k0 + 16] @ xf[:, k0:k0 + 16].T
        y = acc.T if y is None else y + acc.T
    return y


@pytest.mark.parametrize("k", [896, 4864])
@pytest.mark.parametrize("n", [128, 896])
@pytest.mark.parametrize("m", [17, 130])
def test_sm90_emulation_matches_pallas_interpret(m, n, k):
    """Against the Pallas kernel in interpret mode on the same bf16 values
    (as fp32 arrays): the same exact products summed in fp32 in another
    order, within 3e-5 x max|want|."""
    rng = np.random.default_rng(m * n + k)
    x = t(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    w_q = t(rng.integers(-127, 128, (n, k)).astype(np.int8))
    want = np.asarray(jax_int8_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(w_q.numpy()),
                                      interpret=True))
    got = sm90_emulation(x, w_q)
    assert got.shape == (m, n)
    assert np.abs(got.numpy() - want).max() <= 3e-5 * np.abs(want).max()


@pytest.mark.parametrize("m,n,k", [(128, 896, 4864), (512, 128, 896), (64, 6564, 80)])
def test_sm90_emulation_matches_plain(m, n, k):
    """Against K2's plain version (fp32 matmul of the same values) at a
    prefill shape with 13 splits, one with 4, and a 64-row tile with a K tail
    of 16 past the last 64-wide tile: within 3e-5 x max|want|."""
    rng = np.random.default_rng(m + n + k)
    x = t(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    w_q = t(rng.integers(-128, 128, (n, k)).astype(np.int8))
    want = port_i8.int8_matmul_reference(x, w_q)
    got = sm90_emulation(x, w_q)
    assert (got - want).abs().max().item() <= 3e-5 * want.abs().max().item()
