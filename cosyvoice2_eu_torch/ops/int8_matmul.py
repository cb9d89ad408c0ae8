"""Int8 weight-only matmul (kernel K2): y32 = x @ w_q^T, unscaled.

Counterpart of ``cosyvoice2_eu_tpu/ops/pallas/int8_matmul.py::int8_matmul``.
On a CUDA tensor ``int8_matmul`` launches the hand-written Hopper kernel
``csrc/int8_matmul.cu``, which reads the int8 weights from device memory
once and converts them in registers; on a CPU tensor it runs the plain
PyTorch version, and on no other device.  There is no fallback from the card
to the plain version.

Unlike the TPU kernel, which asserts K % 128 == 0 (the JAX package sends any
other K to XLA), K2 takes any K: a ragged K tail is masked inside the
kernel.  So on the card every int8 layer goes through K2, the small
configs' K = 64 and 128 included.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "int8_matmul.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: x (M, K) float, w_q (N, K) int8 -> (M, N) fp32."""
    return x.float() @ w_q.float().T


def _check(x: torch.Tensor, w_q: torch.Tensor) -> None:
    """Raise on what the kernel does not take: device, types, shapes, layout."""
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
def _kernel():
    """The kernel's C entry point (built at first use); looked up once, since
    the decode loop launches it 169 times per token."""
    from cosyvoice2_eu_torch.ops.cuda_build import load_library

    fn = load_library(SOURCE).cosy_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32 or bfloat16, w_q (N, K) int8 -> x @ w_q^T (M, N) float32.

    Any M, N and K.  ``int8_matmul.launches`` counts K2 launches.
    """
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q)
    _check(x, w_q)
    (m, k), n = x.shape, w_q.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _kernel()(x.data_ptr(), w_q.data_ptr(), y.data_ptr(), m, n, k, _DTYPES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel failed: CUDA error {err}")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0
