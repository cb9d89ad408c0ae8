"""K2's decode design (``csrc/int8_matmul_decode_sm90.cu``) on the CPU: the
routing between K2's three designs, the cluster split of K that
``decode_config`` picks, the kernel's int8 -> fp32 conversion over all 256
codes, and a torch emulation of the kernel's sums held against the Pallas
kernel in interpret mode and against the plain version, within the
tolerance ``chip_smoke.py`` holds the card's kernel to (3e-5 x max|want|).

The emulation follows the kernel: each rank of the cluster owns a run of K
(``decode_runs``); within it, 16-wide group g goes to lane g % 32 (the
stages are 512 wide, one group a lane), and each lane adds its exact
products into one fp32 accumulator in increasing K (one rounding per FMA);
the warp then adds its lanes with a shuffle tree (xor 16, 8, 4, 2, 1), and
rank 0 adds the ranks' partials in rank order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import t

from cosyvoice2_eu_torch.ops import int8_matmul as port_i8
from cosyvoice2_eu_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul

DECODE, SM90, FMA = port_i8.DECODE_SOURCE, port_i8.SM90_SOURCE, port_i8.SOURCE
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,m,k,aligned,want", [
    *[(dtype, m, k, True, DECODE) for dtype in (BF16, FP32) for m in (1, 4, 8)
      for k in (896, 4864)],
    (BF16, 9, 896, True, SM90),        # one row past the decode tile, bf16: wgmma
    (FP32, 9, 896, True, FMA),         # fp32 above the decode tile: FMA (no TF32)
    (BF16, 1, 100, True, FMA),         # ragged K: no bulk copy of a row
    (FP32, 4, 100, True, FMA),
    (BF16, 1, 896, False, FMA),        # a base off 16 bytes
    (FP32, 4, 4864, False, FMA),
    (BF16, 1, 8 * 4096 + 16, True, FMA),  # runs past shared memory even at C = 8
])
def test_design_routes_decode_rows(dtype, m, k, aligned, want):
    """One design per launch: M <= 8 with K % 16 == 0 and aligned bases takes
    the decode design, in bf16 and fp32."""
    assert port_i8.design(dtype, m, k, aligned) == want


# (channels a block, C, blocks) of each decode shape, as
# csrc/int8_matmul_decode_sm90.cu's note states it
DECODE_GRIDS = {
    (128, 896): (8, 1, 16), (896, 896): (8, 1, 112), (4864, 896): (8, 1, 608),
    (896, 4864): (8, 2, 224), (6564, 896): (16, 1, 411),
}


@pytest.mark.parametrize("k", [16, 64, 896, 4864])
@pytest.mark.parametrize("n", [33, 128, 896, 4864, 6564])
def test_decode_config_covers_k_once(n, k):
    """8 or 16 channels a block; C is a power of two up to 8; every rank's
    run is non-empty, a multiple of 16 and at most ``DECODE_MAX_RUN``, and
    the runs cover K exactly once, in order; the same at every M of the
    decode tile."""
    for m in range(1, port_i8.DECODE_ROWS + 1):
        channels, c = port_i8.decode_config(m, n, k)
        assert channels in port_i8.DECODE_CHANNELS and c in (1, 2, 4, 8)
        assert channels == 8 or -(-n // 8) > port_i8.DECODE_MAX_BLOCKS
        runs = port_i8.decode_runs(k, c)
        assert len(runs) == c
        pos = 0
        for start, length in runs:
            assert start == pos and 0 < length <= port_i8.DECODE_MAX_RUN and length % 16 == 0
            pos += length
        assert pos == k


def test_decode_config_grids_of_the_decode_shapes():
    """The grids of the LM's decode shapes are the source note's, and the
    large shapes get at least 1.5 blocks an SM."""
    for (n, k), (channels, c, blocks) in DECODE_GRIDS.items():
        for m in (1, 4):
            assert port_i8.decode_config(m, n, k) == (channels, c)
            assert -(-n // channels) * c == blocks
    for n, k in ((4864, 896), (896, 4864), (6564, 896)):
        channels, c = port_i8.decode_config(1, n, k)
        assert -(-n // channels) * c >= 1.5 * port_i8.SM_COUNT


def i8x4_to_f32(words: np.ndarray) -> np.ndarray:
    """The kernel's ``i8x4_to_f32`` on uint32 words: byte i of u = word ^
    0x80808080 into the low mantissa of the float 2^23, minus 2^23 + 128."""
    u = words ^ np.uint32(0x80808080)
    out = [(((u >> np.uint32(8 * i)) & np.uint32(0xFF)) | np.uint32(0x4B000000)).view(np.float32)
           - np.float32(8388736.0) for i in range(4)]
    return np.stack(out, -1).reshape(-1)


def test_int8_to_f32_conversion_exact_for_all_codes():
    """All 256 codes at all four byte positions of a word: the float the
    kernel makes equals float(w) bit for bit."""
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    for shift in range(4):
        rolled = np.roll(codes, shift)
        got = i8x4_to_f32(rolled.view(np.uint32))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      rolled.astype(np.float32).view(np.uint32))


def decode_emulation(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The decode design's arithmetic: x (M, K) bf16 or fp32, w_q (N, K)
    int8 -> (M, N) fp32.  Each FMA rounds once: the product is formed in
    float64 (exact for these operands) and the sum rounded to fp32."""
    (m, k), n = x.shape, w_q.shape[0]
    _, cluster = port_i8.decode_config(m, n, k)
    y = None
    for start, length in port_i8.decode_runs(k, cluster):
        stages = -(-length // 512)
        pad = stages * 512 - length  # zero products leave a sum unchanged
        xr = F.pad(x.double()[:, start:start + length], (0, pad)).reshape(m, stages, 32, 16)
        wr = F.pad(w_q.double()[:, start:start + length], (0, pad)).reshape(n, stages, 32, 16)
        acc = torch.zeros((32, m, n), dtype=torch.float32)  # one accumulator a lane
        for s in range(stages):
            for e in range(16):
                prod = xr[:, s, :, e].T[:, :, None] * wr[:, s, :, e].T[:, None, :]
                acc = (acc.double() + prod).float()
        lanes = torch.arange(32)
        for off in (16, 8, 4, 2, 1):  # __shfl_xor_sync tree
            acc = acc + acc[lanes ^ off]
        y = acc[0] if y is None else y + acc[0]  # rank order
    return y


@pytest.mark.parametrize("k", [896, 4864])
@pytest.mark.parametrize("n", [128, 896])
@pytest.mark.parametrize("m", [1, 4])
def test_decode_emulation_matches_pallas_interpret(m, n, k):
    """Against the Pallas kernel in interpret mode on the same bf16 values (as
    fp32 arrays): the same exact products summed in fp32 in another order,
    within 3e-5 x max|want|; C is 1 at K = 896 and 2 or 4 at K = 4864."""
    rng = np.random.default_rng(m * n + k)
    x = t(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    w_q = t(rng.integers(-127, 128, (n, k)).astype(np.int8))
    want = np.asarray(jax_int8_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(w_q.numpy()),
                                      interpret=True))
    got = decode_emulation(x, w_q)
    assert got.shape == (m, n)
    assert np.abs(got.numpy() - want).max() <= 3e-5 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("m,n,k", [(8, 6564, 896), (3, 33, 64)])
def test_decode_emulation_matches_plain(m, n, k, dtype):
    """Against K2's plain version (fp32 matmul of the same values) at the
    speech head's width with a ragged channel tail (6564 = 410 x 16 + 4) and
    at a small-config shape (one rank, one partial stage), in bf16 and
    fp32: within 3e-5 x max|want|."""
    rng = np.random.default_rng(m + n + k)
    x = t(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    w_q = t(rng.integers(-128, 128, (n, k)).astype(np.int8))
    want = port_i8.int8_matmul_reference(x, w_q)
    got = decode_emulation(x, w_q)
    assert got.shape == (m, n)
    assert (got - want).abs().max().item() <= 3e-5 * want.abs().max().item()
