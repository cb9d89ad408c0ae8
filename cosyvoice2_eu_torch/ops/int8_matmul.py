"""Int8 weight-only matmul (kernel K2): y32 = x @ w_q^T, unscaled.

Counterpart of ``cosyvoice2_eu_tpu/ops/pallas/int8_matmul.py::int8_matmul``.
On a CUDA tensor ``int8_matmul`` launches one of three hand-written Hopper
kernels, chosen by ``design`` before the launch from the dtype, the shape
and the alignment:

- ``csrc/int8_matmul_decode_sm90.cu`` (decode: bfloat16 or float32 x with at
  most 8 rows): bulk asynchronous copies of the weight rows into a ring of
  shared-memory stages, x staged once as fp32, the int8 converted in
  registers for exact fp32 FMAs, K split across a thread-block cluster and
  reduced in distributed shared memory in a fixed order (``decode_config``);
- ``csrc/int8_matmul_sm90.cu`` (prefill: bfloat16 x with more rows than a
  decode tile): TMA loads into a ring of shared-memory stages, the int8
  weights converted to bf16 in registers and multiplied on the tensor cores
  by ``wgmma``, K split over more blocks where the output tiles alone would
  leave SMs idle (``sm90_config``);
- ``csrc/int8_matmul.cu`` (everything else: float32 x above 8 rows, K not a
  multiple of 16, bases off 16-byte boundaries): reads the weights once at
  16 bytes a lane and converts them in registers for fp32 FMAs.

On a CPU tensor it runs the plain PyTorch version, and on no other device.
There is no fallback from the card to the plain version, nor between the
designs.

Unlike the TPU kernel, which asserts K % 128 == 0 (the JAX package sends any
other K to XLA), K2 takes any K: the FMA design masks a ragged K tail
inside.  So on the card every int8 layer goes through K2, the small
configs' K = 64 and 128 included.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "int8_matmul.cu"            # FMA design: fp32 x above 8 rows, ragged K, unaligned
SM90_SOURCE = "int8_matmul_sm90.cu"  # wgmma design: bf16 x at prefill
DECODE_SOURCE = "int8_matmul_decode_sm90.cu"  # bulk copies, cluster split-K: M <= 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 8   # the decode design's largest row tile: M up to it is decode
DECODE_CHANNELS = (8, 16)  # output channels per block of the decode design
DECODE_MAX_BLOCKS = 660  # 8-channel blocks the decode design takes at most: 5 per SM
DECODE_BLOCKS = 198    # blocks the decode design's K split aims for: 1.5 per SM
DECODE_MIN_RUN = 1024  # K a rank of the decode design keeps at least, where K allows
DECODE_MAX_RUN = 4096  # K a rank of the decode design holds at most (x in shared memory)
DECODE_MAX_CLUSTER = 8  # the portable limit of a thread-block cluster
SM_COUNT = 132    # H100 SXM
K_TILE = 64       # K per stage of the wgmma design
MIN_SPLIT_TILES = 3  # K tiles a split of the wgmma design holds at least


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: x (M, K) float, w_q (N, K) int8 -> (M, N) fp32."""
    return x.float() @ w_q.float().T


def design(dtype: torch.dtype, m: int, k: int, aligned: bool) -> str:
    """The source a CUDA launch of K2 takes, for x of ``dtype`` with ``m``
    rows and ``k`` columns; ``aligned`` says x and w_q start on 16-byte
    boundaries.  Both bulk copies and TMA need K % 16 == 0 and aligned
    bases.  Then x with at most 8 rows, bf16 or fp32 (its products are
    exact in fp32 on the FMA units), takes the decode design up to the K
    that 8 ranks of at most ``DECODE_MAX_RUN`` hold, and bf16 x above 8
    rows the wgmma design; fp32 x above 8 rows stays on the FMA design
    (TF32 would round x), and so does everything else."""
    if k % 16 != 0 or not aligned:
        return SOURCE
    if m <= DECODE_ROWS:
        return DECODE_SOURCE if k <= DECODE_MAX_CLUSTER * DECODE_MAX_RUN else SOURCE
    return SM90_SOURCE if dtype == torch.bfloat16 else SOURCE


def decode_runs(k: int, cluster: int) -> list[tuple[int, int]]:
    """(start, length) of each rank's run of K in the decode design: K in
    groups of 16, cut into ``cluster`` runs of cdiv(groups, cluster) groups
    (the last may be shorter)."""
    per = -(-(k // 16) // cluster) * 16
    return [(r * per, min(k, (r + 1) * per) - r * per) for r in range(cluster)]


def decode_config(m: int, n: int, k: int) -> tuple[int, int]:
    """(channels, cluster) of a launch of the decode design.  A block owns 8
    output channels, or 16 where 8-channel blocks would exceed
    ``DECODE_MAX_BLOCKS`` (5 per SM), and a cluster of C blocks splits K into
    contiguous runs.  C is the smallest power of two up to 8 that gives
    ``DECODE_BLOCKS`` blocks (1.5 per SM), as long as every run keeps
    ``DECODE_MIN_RUN`` of K and none is empty; and at least the power of two
    whose runs fit ``DECODE_MAX_RUN`` (x is staged in shared memory).  The
    same at every M up to 8."""
    channels = 8 if -(-n // 8) <= DECODE_MAX_BLOCKS else 16
    groups = -(-n // channels)
    cluster = 1
    while cluster < DECODE_MAX_CLUSTER:
        fits = max(length for _, length in decode_runs(k, cluster)) <= DECODE_MAX_RUN
        if fits and groups * cluster >= DECODE_BLOCKS:
            break
        runs = decode_runs(k, 2 * cluster)
        if min(length for _, length in runs) <= 0 or (fits and runs[0][1] < DECODE_MIN_RUN):
            break
        cluster *= 2
    return channels, cluster


def sm90_config(m: int, n: int, k: int) -> tuple[int, int]:
    """(rows, splits) of a launch of the wgmma design.  A block owns 64
    output channels and ``rows`` rows of x: 64 up to M = 64, else 128.  K is
    split only when the output tiles fill fewer than half the card's SMs:
    then into enough splits for about 1.5 blocks per SM, each holding at
    least ``MIN_SPLIT_TILES`` K tiles of 64.  The K tiles are cut into runs
    of equal length (the last may be shorter), none empty."""
    rows = 64 if m <= 64 else 128
    tiles = -(-n // 64) * -(-m // rows)
    k_tiles = -(-k // K_TILE)
    splits = 1
    if 2 * tiles < SM_COUNT:
        splits = max(1, min(-(-3 * SM_COUNT // (2 * tiles)), k_tiles // MIN_SPLIT_TILES))
        splits = -(-k_tiles // -(-k_tiles // splits))
    return rows, splits


def _check(x: torch.Tensor, w_q: torch.Tensor) -> None:
    """Raise on what the kernels do not take: device, types, shapes, layout."""
    if x.device.type != "cuda" or w_q.device != x.device:
        raise ValueError(f"int8_matmul: x on {x.device} and w_q on {w_q.device}; "
                         "the kernel takes both on one GPU")
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_matmul: x dtype {x.dtype} is not float32 or bfloat16")
    if w_q.dtype != torch.int8:
        raise ValueError(f"int8_matmul: w_q dtype {w_q.dtype} is not int8")
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[1] or 0 in x.shape + w_q.shape:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         "are not (M, K) and (N, K) with M, N, K > 0")
    if not (x.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("int8_matmul: x and w_q must be contiguous")


@functools.cache
def _kernel(source: str):
    """The C entry point of ``source`` (built at first use); looked up once,
    since the decode loop launches K2 169 times per token."""
    from cosyvoice2_eu_torch.ops.cuda_build import load_library

    if source == SM90_SOURCE:
        fn = load_library(source).cosy_int8_matmul_sm90
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    elif source == DECODE_SOURCE:
        fn = load_library(source).cosy_int8_matmul_decode
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    else:
        fn = load_library(source).cosy_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(source: str, x: torch.Tensor, w_q: torch.Tensor, y: torch.Tensor) -> int:
    """Launch ``source``'s kernel on x and w_q into y; returns the CUDA error."""
    (m, k), n = x.shape, w_q.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if source == SM90_SOURCE:
        rows, splits = sm90_config(m, n, k)
        ws = torch.empty((splits - 1, m, n), dtype=torch.float32, device=x.device) \
            if splits > 1 else None
        return _kernel(source)(x.data_ptr(), w_q.data_ptr(), y.data_ptr(),
                               None if ws is None else ws.data_ptr(), m, n, k, rows, splits,
                               stream)
    if source == DECODE_SOURCE:
        channels, cluster = decode_config(m, n, k)
        return _kernel(source)(x.data_ptr(), w_q.data_ptr(), y.data_ptr(), m, n, k,
                               _DTYPES[x.dtype], channels, cluster, stream)
    return _kernel(source)(x.data_ptr(), w_q.data_ptr(), y.data_ptr(), m, n, k,
                           _DTYPES[x.dtype], stream)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32 or bfloat16, w_q (N, K) int8 -> x @ w_q^T (M, N) float32.

    Any M, N and K.  ``int8_matmul.launches`` counts K2 launches (of any
    design).
    """
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q)
    _check(x, w_q)
    (m, k), n = x.shape, w_q.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    source = design(x.dtype, m, k, x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    err = _launch(source, x, w_q, y)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel ({source}) failed: CUDA error {err}")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0
