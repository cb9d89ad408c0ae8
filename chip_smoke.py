#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. print the card's name and power limit, build the CUDA kernels from
     ``cosyvoice2_eu_torch/csrc`` (one nvcc per source, in parallel) and
     print the build time, ptxas's register, spill and shared-memory lines,
     and the count of ``HGMMA`` (wgmma) instructions in the libraries of
     K1's bf16 design and K2's prefill design (it fails at 0 in either);
  2. kernel checks against the plain PyTorch versions on the card: K1
     (flash-attention forward, O and LSE; bf16 on the tensor cores, fp32 on
     the FMA units) and K3/K4 (its backward), every row, at B=2 ragged
     shapes and the training path's two batches, bf16 K1 also at the edges
     of its 128-row tiles (T 1 to 200), with a row of length 0 and at the
     int8 batch's B=8 (640 blocks, several waves), K1 ->
     K3/K4 also against the fully plain forward and backward; K2 (the int8
     matmul) at every (N, K) of the int8 LM, M 1 to 512, bf16 and fp32 x,
     plus a ragged K, and in bf16 at the edges of its wgmma design (M 9 to
     512, N 128 and 6564, K 896 and 4864), each case with the design it
     took (every bf16 case above 8 rows must take the wgmma one);
  3. reference checks on a small config, on the card (kernels included)
     against the plain CPU path with the same weights and draws: the TTS
     pipeline in fp32, unquantized and with ``lm_quant="int8"`` (then also
     equal int8 codes, K2's launch count and the int8-vs-fp32 logits
     band), and one flow train step;
  4. TTS path: ``load(config=TTSConfig(), seed=0, device="cuda")`` at the
     published widths (random weights) answers 3 requests; checks the audio
     and that each flow call launched K1 560 times; per-stage times;
  5. int8 path: the same with ``lm_quant="int8"``: 2 requests, then one
     ``tts_batch`` of 4 prompts; checks the audio, 168 + 169 x steps K2
     launches per LM decode and 560 K1 launches per flow call, and from
     the record of each K2 launch that every prefill launch took the wgmma
     design and every decode launch the FMA one; per-stage times, RTF, the
     int8-vs-bf16 logits on one packed prompt, and ``lm_prefill`` alone at
     one request's and the batch's prompt;
  6. training path: 8 flow-matching steps at the published widths through
     ``Executor.train_epoch`` (``TrainConfig()`` defaults, accum_grad 4),
     then CV and an end-of-epoch checkpoint; checks finite losses, the
     MultiSteps update at step 4, 56 launches of K1 (with LSE), K3 and K4
     per step, and a bit-exact checkpoint round trip; per-step times;
  7. kernel timings at the shapes of the paths: K1 on all three (with
     TFLOP/s on the visible pairs and the share of the bound, and its
     output at each timed shape held against the plain one), K2 at every
     (M, N, K) of the int8 path with its weights cold in L2 (its output
     held against the plain one, with TFLOP/s and the share of the bound,
     beside its plain version, ``torch._weight_int8pack_mm`` where the
     card's PyTorch runs it, and ``F.linear`` on the bf16 weights), and
     K2's time summed over one prefill beside ``lm_prefill``'s.
The line before the last is the kernels JSON (K1, K2, K3, K4): K1's times
are means per launch over the paths (each path's under ``by_path``, each
design's under ``by_dtype``: bf16 on the TTS and int8 paths, fp32 on the
training path), K2's over the int8 path's shapes (each under ``by_shape``,
with ``bf16_linear_ms``; each design's under ``by_design``: the wgmma one
at prefill, the FMA one at decode); K3's and K4's ``plain_ms`` time the
plain dQ and dK/dV alone, their ``library_ms`` is null (no library call
computes one of them alone), and ``backward_*ms`` time the whole backward
as delta + K3 + K4, the plain version and SDPA's.  The last line is
``{"ok": true, "device": {...}}``.  The script imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores (FMA), H100 SXM data sheet
H100_BYTES = 3.35e12      # HBM3 bandwidth
PEAKS = {"torch.float32": H100_FP32_FLOPS, "torch.bfloat16": H100_BF16_FLOPS}


def _counters() -> tuple:
    """The kernel wrappers whose ``launches`` counts show a path's launches:
    K1, K3, K4, K2."""
    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.ops import int8_matmul as i8

    return fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv, i8.int8_matmul


def _uncounted(fn):
    """Launches made inside ``fn`` (comparisons, references, timing) do not count."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = [f.launches for f in _counters()]
        try:
            return fn(*args, **kwargs)
        finally:
            for f, n in zip(_counters(), saved):
                f.launches = n

    return run


def _graph_ms(fn, n: int) -> float:
    """Device ms per call of ``fn(i)``, i = 0 .. n-1, captured in one CUDA
    graph and timed as its replay.  At tens of microseconds a call, eager
    launches from Python would time the host's launch rate, not the card."""
    import torch

    side = torch.cuda.Stream()  # warm-up off the capture stream (library handles)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# mel frames of the training path's two batches (longest x rows <= 3000) and
# of its CV batch
TRAIN_SHAPES = ([740, 690, 610, 520], [1480, 1210])
CV_SHAPE = TRAIN_SHAPES[0]


def _check_cases(ts) -> list:
    """Lengths of each kernel check: B=2 ragged at each T in ``ts``, then the
    training path's two batches exactly (T 740 and 1480, not multiples of 64)."""
    return [[t, (3 * t) // 5 + 7] for t in ts] + [list(lens) for lens in TRAIN_SHAPES]


# K1's tolerances.  fp32: the kernel and the plain version both compute in
# fp32 and differ only in summation order, 1e-4.  bf16: both round the same
# fp32 result to bf16, so they may differ by one bf16 ulp, at most 2^-7 of
# the largest output; the kernel's one extra rounding (P to bf16 before P V,
# about 2^-9 |v| / sqrt(n_eff) on O) stays well inside it.  The LSE is fp32
# for either input type, |LSE| < 10 here: a few fp32 ulps, 1e-5.
K1_LSE_TOL = 1e-5


def _k1_errors(got, want, dtype, with_lse: bool) -> tuple:
    """(O error, O tolerance, LSE error, ok) of K1's ``got`` against the plain
    ``want`` (each o, or (o, lse) with LSE), on every row."""
    if not with_lse:
        got, want = (got, None), (want, None)
    peak = want[0].float().abs().max().item()
    err = (got[0].float() - want[0].float()).abs().max().item()
    lse_err = (got[1] - want[1]).abs().max().item() if with_lse else 0.0
    tol = 1e-4 if str(dtype) == "torch.float32" else 2.0 ** -7 * peak
    ok = math.isfinite(err) and math.isfinite(lse_err) and err <= tol and lse_err <= K1_LSE_TOL
    return err, tol, lse_err, ok


@_uncounted
def check_flash_attention() -> float:
    """K1 against its plain version at the shapes of both paths, with and
    without LSE; O and LSE compared on every row (pad rows included, which
    K3 and K4 read).  bf16 also at the edges of the sm90 kernel's 128-row
    tiles (T 1 to 200), with a row of length 0 (at chunk 0 the mean of V
    over all T keys on both sides), and at the int8 batch's shape (B=8 at
    T 1280: 640 blocks, more than one wave of the card).  Returns the worst
    O error."""
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    h, d = 8, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    both = (torch.bfloat16, torch.float32)
    cases = [(lens, max(lens), both, (0, 50), "")
             for lens in _check_cases((128, 384, 1280, 1536, 2048))]
    cases += [([t, max(1, (3 * t) // 5)], t, (torch.bfloat16,), (0, 50), " edge")
              for t in (1, 64, 65, 127, 129, 200)]
    cases.append(([200, 0], 200, (torch.bfloat16,), (0,), " edge"))
    # the int8 path's tts_batch of 4 (CFG doubles the rows) in its mel bucket
    cases.append(([1150, 1270, 730, 1190] * 2, 1280, (torch.bfloat16,), (0, 50), " int8 batch"))
    worst = 0.0
    for lens, t, dtypes, chunks, what in cases:
        b = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for dtype in dtypes:
            q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            for chunk in chunks:
                for with_lse in (False, True):
                    got = fa.flash_attention(q, k, v, lengths, chunk, return_lse=with_lse)
                    want = fa.flash_attention_reference(q, k, v, lengths, chunk,
                                                        return_lse=with_lse)
                    err, tol, lse_err, ok = _k1_errors(got, want, dtype, with_lse)
                    print(f"K1{what} check lengths={lens} T={t} {str(dtype)[6:]} chunk={chunk} "
                          f"lse={with_lse}, every row: max_abs_err={err:.3e} (tol {tol:.3e}) "
                          f"lse_err={lse_err:.3e} (tol {K1_LSE_TOL:g}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"K1 disagrees with its plain version at lengths={lens}")
                    worst = max(worst, err)
    return worst


@_uncounted
def check_flash_backward() -> tuple[float, float]:
    """K3 and K4 against their plain version: B=2 ragged at T from 128 to
    2048 and the training path's two batches exactly; fp32 and bf16, chunk 0
    and 50.  dQ is compared on every query row (pad rows included), dK/dV on
    every key, and dK/dV must be exactly 0 on keys at or past length[b].
    Two comparisons per case: both sides take K1's O and LSE (K3 and K4
    alone), and, in fp32, the port's chain (K1, delta, K3, K4) against the
    fully plain chain (the plain forward's O and LSE into the plain
    backward).  Returns the worst dQ and dK/dV errors of the first.  Also:
    the forward under autograd equals the inference launch."""
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    # fp32: the kernels and the plain version compute in fp32 and differ only
    # in summation order, 1e-4 x max(1, max|want|).  bf16: both round the same
    # fp32 result once, so one bf16 ulp, 2^-7 of the largest output.
    h, d = 8, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = {"dq": 0.0, "dkv": 0.0}
    for lens in _check_cases((128, 384, 740, 1480, 2048)):
        b, t = len(lens), max(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            for chunk in (0, 50):
                o, lse = fa.flash_attention(q, k, v, lengths, chunk, return_lse=True)
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, lengths, chunk)
                refs = {"K1's O/LSE": fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                                        lengths, chunk)}
                if dtype == torch.float32:
                    o_p, lse_p = fa.flash_attention_reference(q, k, v, lengths, chunk,
                                                              return_lse=True)
                    refs["plain chain"] = fa.flash_attention_bwd_reference(
                        q, k, v, o_p, lse_p, do, lengths, chunk)
                torch.cuda.synchronize()
                ok, parts = True, []
                for ref, want in refs.items():
                    errs = []
                    for name, g, w in zip(("dq", "dk", "dv"), got, want):
                        peak = w.float().abs().max().item()
                        err = (g.float() - w.float()).abs().max().item()
                        tol = 1e-4 * max(1.0, peak) if dtype == torch.float32 else 2.0 ** -7 * peak
                        ok = ok and math.isfinite(err) and err <= tol
                        errs.append(f"{name} {err:.3e} (tol {tol:.3e})")
                        if ref == "K1's O/LSE":
                            key = "dq" if name == "dq" else "dkv"
                            worst[key] = max(worst[key], err)
                    parts.append(f"vs {ref}: {', '.join(errs)}")
                zero_past = all(not got[1][i, :, n:].any().item() and not got[2][i, :, n:].any().item()
                                for i, n in enumerate(lens))
                ok = ok and zero_past
                print(f"K3/K4 check lengths={lens} T={t} {str(dtype)[6:]} chunk={chunk}, every "
                      f"row and key: max_abs_err {'; '.join(parts)}; dK=dV=0 past length: "
                      f"{zero_past} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"K3/K4 disagree with their plain version at lengths={lens}")
    # the differentiable forward (K1 with LSE) equals the inference launch
    q, k, v = (torch.randn((2, h, 740, d), generator=gen, device="cuda") for _ in range(3))
    lengths = torch.tensor([740, 451], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        o_inf = fa.flash_attention(q, k, v, lengths, 50)
    o_grad = fa.flash_attention(q.requires_grad_(), k, v, lengths, 50)
    same = o_grad.grad_fn is not None and torch.equal(o_grad.detach(), o_inf)
    print(f"K1 forward under autograd equals the inference launch: {same} "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("the differentiable forward differs from the inference launch")
    return worst["dq"], worst["dkv"]


def _k2_shapes(cfg) -> list:
    """(N, K, launches per layer) of the int8 LM's projections: q, k/v, o,
    gate/up, down; then the speech head (N, K, 0), launched once per step."""
    bb = cfg.llm.backbone
    h, q, kv = bb.hidden_size, bb.num_heads * bb.head_dim, bb.num_kv_heads * bb.head_dim
    return [(q, h, 1), (kv, h, 2), (h, q, 1), (bb.intermediate_size, h, 2),
            (h, bb.intermediate_size, 1), (cfg.llm.full_vocab, h, 0)]


# K2's tolerance: int8 x bf16 (or fp32) products are exact in fp32, so the
# kernel and the plain version differ only in the order of the fp32 sums
# over K (per k-step and K split in the wgmma design): 3e-5 x max|want|.
K2_TOL = 3e-5

# launches of K2 by (source, M) since a path cleared it, as seen at each launch
K2_LAUNCHED: dict = {}


def _record_k2_launches(i8) -> None:
    """From now on, count in ``K2_LAUNCHED`` the source and M of each of
    K2's launches, at the launch."""
    launch = i8._launch

    def recorded(source, x, w_q, y):
        key = (source, x.shape[0])
        K2_LAUNCHED[key] = K2_LAUNCHED.get(key, 0) + 1
        return launch(source, x, w_q, y)

    i8._launch = recorded


def _k2_took(x, w_q):
    """K2 on (x, w_q) and the source its one launch called, from the record."""
    from cosyvoice2_eu_torch.ops import int8_matmul as i8

    K2_LAUNCHED.clear()
    y = i8.int8_matmul(x, w_q)
    (source, _), = K2_LAUNCHED
    return y, source


@_uncounted
def check_int8_matmul() -> float:
    """K2 against its plain version at every (N, K) of the full-width int8 LM
    and M 1, 3, 4, 17, 128, 512 (decode of 1 and 4 rows, ragged tiles,
    prefill of 1 and 4 prompts), x in bf16 and fp32; a ragged K (100) on
    weights that start off a 16-byte boundary; and in bf16 the edges of the
    wgmma design: M 9 (one past the decode tile), 64 (its 64-row tile), 130
    and 257 (a few rows into the next 128-row tile), 512, at N 128 and 6564
    (a ragged last channel tile) and K 896 and 4864 (1 to 19 K splits).
    Each case prints the design it took; every bf16 case with M > 8 must
    take the wgmma design, every other case the FMA one.  Returns the worst
    error."""
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.ops import int8_matmul as i8
    from cosyvoice2_eu_torch.utils.device import resolve_device

    resolve_device("cuda")  # the plain version's fp32 matmul without TF32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    both = (torch.bfloat16, torch.float32)
    nk = dict.fromkeys((n, k) for n, k, _ in _k2_shapes(TTSConfig()))  # q and o share a shape
    cases = [(n, k, m, both) for n, k in nk for m in (1, 3, 4, 17, 128, 512)]
    cases += [(33, 100, 1, both), (33, 100, 5, both)]
    cases += [(n, k, m, (torch.bfloat16,)) for n in (128, 6564) for k in (896, 4864)
              for m in (9, 64, 130, 257, 512)]
    worst = 0.0
    for n, k, m, dtypes in cases:
        w_q = torch.randint(-127, 128, (n * k + 1,), generator=gen, device="cuda",
                            dtype=torch.int8)
        # a ragged K also starts its weights one byte off a 16-byte boundary:
        # the FMA design's byte-load path
        w_q = w_q[1:].view(n, k) if k % 16 else w_q[:-1].view(n, k)
        x32 = torch.randn((m, k), generator=gen, device="cuda")
        for dtype in dtypes:
            x = x32.to(dtype)
            got, took = _k2_took(x, w_q)
            want = i8.int8_matmul_reference(x, w_q)
            torch.cuda.synchronize()
            peak = want.abs().max().item()
            err = (got - want).abs().max().item()
            tol = K2_TOL * peak
            expect = i8.SM90_SOURCE if dtype == torch.bfloat16 and m > i8.DECODE_ROWS \
                and k % 16 == 0 else i8.SOURCE
            ok = got.shape == (m, n) and math.isfinite(err) and err <= tol and took == expect
            print(f"K2 check M={m} N={n} K={k} x {str(dtype)[6:]}"
                  f"{'' if w_q.data_ptr() % 16 == 0 else ' (weights off 16 B)'} took {took}: "
                  f"max_abs_err={err:.3e} (tol {tol:.3e} = {K2_TOL:g} x max|want|) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 failed its check at M={m} N={n} K={k} {dtype}: error "
                                 f"{err:.3e} (tol {tol:.3e}), took {took}, expected {expect}")
            worst = max(worst, err)
    return worst


def _time_k1(lens, t: int, chunk: int, dtype, with_lse: bool, gen) -> dict:
    """K1, its plain version and SDPA's forward on random inputs of one shape,
    each as CUDA-graph replay, with K1's bound from this run's visible pairs
    (ms each).  K1's output at this shape is held against the plain one
    first (``err``), and a disagreement ends the run."""
    import torch
    import torch.nn.functional as F

    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.ops.masks import chunk_attention_mask

    h, d = 8, 64
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    mask = chunk_attention_mask(lengths, t, chunk)[:, None]
    err, tol, lse_err, ok = _k1_errors(
        fa.flash_attention(q, k, v, lengths, chunk, return_lse=with_lse),
        fa.flash_attention_reference(q, k, v, lengths, chunk, return_lse=with_lse), dtype, with_lse)
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version at the timed shape lengths={lens} "
                         f"T={t} chunk={chunk}: max_abs_err={err:.3e} (tol {tol:.3e}), "
                         f"lse_err={lse_err:.3e}")
    ms = _graph_ms(lambda i: fa.flash_attention(q, k, v, lengths, chunk, return_lse=with_lse), 50)
    plain_ms = _graph_ms(lambda i: fa.flash_attention_reference(q, k, v, lengths, chunk,
                                                               return_lse=with_lse), 10)
    library_ms = _graph_ms(lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50)
    # the same launches made eagerly from Python: the rate the wrapper sets
    eager_ms = _cuda_ms(lambda: fa.flash_attention(q, k, v, lengths, chunk,
                                                   return_lse=with_lse), 50)
    flops = 4 * d * int(mask.sum().item()) * h  # visible (query, key) pairs of this run's data
    # q, k, v read; o (and lse) written; lengths
    nbytes = 4 * b * h * t * d * q.element_size() + (b * h * t * 4 if with_lse else 0) + b * 4
    ops_ms = flops / PEAKS[str(dtype)] * 1e3
    bytes_ms = nbytes / H100_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, eager_ms=eager_ms,
                bound_ms=bound_ms, ops_ms=ops_ms, bytes_ms=bytes_ms, gflop=flops / 1e9,
                mb=nbytes / 1e6, tflops=flops / ms * 1e-9, share=bound_ms / ms)


def _weighted(parts: list) -> dict:
    """Launch-weighted means of the times of (launches, times) pairs, the
    mean per launch over a path; a time that is None stays None."""
    total = sum(n for n, _ in parts)
    keys = [k for k in parts[0][1] if k.endswith("_ms") or k == "ms"]
    out = {k: None if parts[0][1][k] is None else sum(n * p[k] for n, p in parts) / total
           for k in keys}
    out.update(launches=total, bound_by="operations" if out["ops_ms"] >= out["bytes_ms"]
               else "bytes")
    return out


@_uncounted
def time_flash_attention(shapes: list, launches: int, card: str) -> tuple[dict, list]:
    """K1, its plain version and SDPA at each flow call's shape of a TTS path.

    ``shapes`` holds (T, valid mel frames of each of K1's batch rows) per
    flow call (the CFG halves double the rows), and each call launches K1
    equally often.  Returns the path's mean per launch and the kernel's ms
    at each call's shape.
    """
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for t, lens in shapes:
        r = _time_k1(lens, t, 0, torch.bfloat16, False, gen)
        print(f"K1 timing T={t} bf16 chunk=0 lengths={lens} [{card}]: kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s on the visible pairs, {100 * r['share']:.1f}% of the "
              f"bound; eager from Python {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['gflop']:.2f} GFLOP, {r['mb']:.2f} MB); output vs plain max_abs_err "
              f"{r['err']:.3e} ok")
        rows.append(r)
    return _weighted([(launches // len(rows), r) for r in rows]), [r["ms"] for r in rows]


def _prompt(cfg, seconds: float, seed: int = 0) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    n_sp = int(seconds * cfg.flow.input_frame_rate)
    return {
        "prompt_feat": (rng.standard_normal((n_sp * cfg.token_mel_ratio, cfg.flow.output_size))
                        * 0.5 - 4.0).astype(np.float32),
        "speech_tokens": rng.integers(0, cfg.llm.speech_token_size, n_sp).astype(np.int32),
        "embedding": rng.standard_normal(cfg.frontend.spk_embed_dim).astype(np.float32),
        "prompt_text": "",
    }


def check_small_reference(lm_quant=None) -> None:
    """The pipeline on the card (K1 included, fp32) against the plain CPU path.

    With ``lm_quant="int8"`` also: the card's int8 codes and scales equal the
    CPU's bit for bit, K2 launched 7 L + (7 L + 1) x steps times in the
    card's LM decode, and on the card the int8 logits of ``lm_training_hidden``
    stay within the JAX package's band of the fp32 ones."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import tiny_test_config
    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm import init_lm
    from cosyvoice2_eu_torch.ops import int8_matmul as i8
    from cosyvoice2_eu_torch.ops.sampling import gumbel
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    cfg = tiny_test_config()
    # K1 takes the estimator's head dim of 64: a small estimator with 64-wide heads
    cfg = dataclasses.replace(cfg, flow=dataclasses.replace(
        cfg.flow, estimator=dataclasses.replace(cfg.flow.estimator, attention_head_dim=64,
                                                num_heads=2)))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    params = {"llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
              "hift": init_hift(gen, cfg.hift)}
    g_lm = torch.Generator(device="cpu")
    g_lm.manual_seed(2)
    lm_noise = [(gumbel((1, cfg.llm.top_k), g_lm), gumbel((1, cfg.llm.full_vocab), g_lm))
                for _ in range(1024)]
    g_h = torch.Generator(device="cpu")
    g_h.manual_seed(3)
    cache = {}

    def hift_draws(b, length, harmonics):
        if length not in cache:
            cache[length] = (torch.rand((b, harmonics), generator=g_h),
                             torch.randn((b, length, harmonics), generator=g_h))
        return cache[length]

    prompt = Frontend(cfg).frontend_zero_shot("Bonjour tout le monde.", _prompt(cfg, 0.24, 4))
    out = {}
    for dev in ("cpu", "cuda"):
        model = cosy.load(config=cfg, params=params, device=dev, compute_dtype="float32",
                          lm_quant=lm_quant)._model
        lm_draws = lambda step: tuple(x.to(dev) for x in lm_noise[step])
        before = i8.int8_matmul.launches
        wav = next(model.tts(prompt, lm_draws=lm_draws,
                             hift_draws=lambda *s: tuple(x.to(dev) for x in hift_draws(*s))))
        out[dev] = (model.last_n_tokens, wav, model.last_decode_steps,
                    i8.int8_matmul.launches - before, model.params["llm"])
    (n_cpu, wav_cpu, _, _, llm_cpu), (n_gpu, wav_gpu, steps, k2, llm_gpu) = out["cpu"], out["cuda"]
    err = float(np.abs(wav_cpu - wav_gpu).max()) if n_cpu == n_gpu else float("inf")
    tol = 1e-3  # fp32 through ~40 layers, different summation orders
    ok = n_cpu == n_gpu and np.isfinite(wav_gpu).all() and err <= tol
    what = "unquantized" if lm_quant is None else lm_quant
    print(f"reference check (small config, fp32, {what} LM, card vs CPU plain path): tokens "
          f"{n_gpu} vs {n_cpu}, audio max_abs_err={err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the card's pipeline ({what} LM) disagrees with the plain CPU path")
    if lm_quant is None:
        return
    n_layers = cfg.llm.backbone.num_layers
    want_k2 = 7 * n_layers + (7 * n_layers + 1) * steps
    differ = [i for i, (a, b) in enumerate(zip(tree_leaves(llm_gpu), tree_leaves(llm_cpu)))
              if not torch.equal(a.cpu(), b)]
    codes_equal = not differ
    band = _int8_logits_band(cfg, params["llm"], "cuda")
    ok = k2 == want_k2 and codes_equal and band[0] < 0.05 and band[1] > 0.9
    print(f"int8 reference check (small config, card): K2 launches {k2} (expected 7 x {n_layers} "
          f"+ (7 x {n_layers} + 1) x {steps} steps = {want_k2}); int8 codes and scales equal the "
          f"CPU's bit for bit: {codes_equal} ({len(differ)} of {len(tree_leaves(llm_cpu))} LM "
          f"leaves differ); lm_training_hidden int8 vs fp32: max|dlogit| / "
          f"max|logit| {band[0]:.4f} (< 0.05), argmax agreement {band[1]:.3f} (> 0.9) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the int8 small-config checks failed")


@_uncounted
def _int8_logits_band(cfg, llm, device, ids=None, src=None, valid=None) -> tuple:
    """(max|int8 logit - logit| / max|logit|, argmax agreement) of
    ``lm_training_hidden`` on ``llm`` and its int8 quantization, over the
    valid positions; by default on the JAX package's test input (2 x 24
    random ids, sources and all valid, seed 1)."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.models.llm import lm_training_hidden
    from cosyvoice2_eu_torch.utils.params import quantize_lm_params, tree_map

    if ids is None:
        rng = np.random.default_rng(1)
        ids = torch.as_tensor(rng.integers(2, 100, (2, 24)))
        src = torch.as_tensor(rng.integers(0, 3, (2, 24)))
        valid = torch.ones((2, 24), dtype=torch.bool)
    ids, src, valid = (x.to(device) for x in (ids, src, valid))
    llm = tree_map(lambda x: x.to(device), llm)
    logits = lm_training_hidden(llm, cfg.llm, ids, src, valid)[valid].float()
    logits_q = lm_training_hidden(quantize_lm_params(llm), cfg.llm, ids, src, valid)[valid].float()
    rel = ((logits_q - logits).abs().max() / logits.abs().max()).item()
    agree = (logits_q.argmax(-1) == logits.argmax(-1)).float().mean().item()
    return rel, agree


# (source, entry point) of each kernel the flash-attention wrappers called
# since a path cleared it with the counts
LAUNCHED: set = set()


def _record_launches(fa) -> None:
    """From now on, note in ``LAUNCHED`` the kernel each of ``fa``'s wrappers
    calls, at the call."""
    fn = fa._fn

    def recorded(source, symbol, n_ptrs):
        LAUNCHED.add((source, symbol))
        return fn(source, symbol, n_ptrs)

    fa._fn = recorded


def _k1_design() -> str:
    """The K1 design the path launched since ``LAUNCHED`` was cleared, as
    seen at each launch.  Raises unless every launch was of the bf16 one."""
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    if LAUNCHED != {fa.fwd_kernel(torch.bfloat16)}:
        raise SystemExit(f"the serving path launched {sorted(LAUNCHED)}, not only K1's bf16 "
                         f"design {fa.fwd_kernel(torch.bfloat16)}")
    return f"every launch called {fa.SM90_SOURCE}, as recorded at each launch"


def main_path(card: str) -> tuple[int, list, list, dict]:
    """Three full-width requests.  Returns K1's launches, each flow call's
    (mel bucket, valid mel frames per K1 row) and flow time in ms, and the
    bf16 LM's parameters."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.runtime.model import FLOW_TOKEN_BUCKETS, bucket_for

    cfg = TTSConfig()
    est = cfg.flow.estimator
    k1_per_flow = (2 + est.num_mid_blocks) * est.n_blocks * cfg.flow.cfm.n_timesteps
    t0 = time.perf_counter()
    model = cosy.load(config=cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: load(TTSConfig(), seed=0, device='cuda') {time.perf_counter() - t0:.2f} s "
          f"[{card}]")
    prompt = _prompt(cfg, 3.0)
    texts = ["Bonjour, comment allez-vous ?", "Guten Morgen, wie geht es dir?",
             "Il fait beau aujourd'hui."]
    n_prompt = len(prompt["speech_tokens"])
    ratio = cfg.token_mel_ratio
    shapes, flow_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for f in _counters():
        f.launches = 0
    LAUNCHED.clear()
    for i, text in enumerate(texts):
        before = fa.flash_attention.launches
        model._model.timer.reset()
        t0 = time.perf_counter()
        wav, sr = model.tts(text, prompt)
        wall = time.perf_counter() - t0
        n_tok = model._model.last_n_tokens
        stages = model._model.timer.summary()
        launched = fa.flash_attention.launches - before
        audio_s = wav.shape[1] / sr
        ok = (wav.shape == (1, n_tok * 2 * 480) and np.isfinite(wav).all()
              and float(np.abs(wav).max()) > 1e-3 and launched == k1_per_flow)
        lm_s = stages["lm_decode"]["total_s"]
        print(f"request {i}: {len(text.encode())} text bytes -> {n_tok} tokens, "
              f"{audio_s:.2f} s audio, shape {wav.shape}, peak |x| {np.abs(wav).max():.3f}; "
              f"K1 launches {launched} (expected {k1_per_flow}); "
              f"LM {lm_s * 1e3 / max(n_tok, 1):.2f} ms/token, "
              f"flow {stages['flow']['total_s'] * 1e3:.1f} ms, "
              f"HiFT {stages['hift']['total_s'] * 1e3:.1f} ms, wall {wall:.2f} s, "
              f"RTF {wall / audio_s:.3f} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"request {i} failed its checks")
        total = n_prompt + n_tok
        shapes.append((bucket_for(total, FLOW_TOKEN_BUCKETS) * ratio, [total * ratio] * 2))
        flow_ms.append(stages["flow"]["total_s"] * 1e3)
    launches = fa.flash_attention.launches
    design = _k1_design()
    print(f"main path: K1 launches {launches} over {len(texts)} flow calls ({design}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if launches != k1_per_flow * len(texts):
        raise SystemExit("K1 launch count does not match the flow calls")
    return launches, shapes, flow_ms, model._model.params["llm"]


def _k2_designs(prefill_rows: set, launches: int) -> str:
    """The K2 designs the int8 path launched since ``K2_LAUNCHED`` was
    cleared, as seen at each launch.  Raises unless every launch at a
    prefill M took the wgmma design, every decode launch (M <= 8) the FMA
    one, and the record holds all ``launches``."""
    from cosyvoice2_eu_torch.ops import int8_matmul as i8

    def expected(m):
        if m in prefill_rows:
            return i8.SM90_SOURCE
        return i8.SOURCE if m <= i8.DECODE_ROWS else None

    bad = {key: c for key, c in K2_LAUNCHED.items() if key[0] != expected(key[1])}
    if bad or sum(K2_LAUNCHED.values()) != launches:
        raise SystemExit(f"int8 path: K2 launches {dict(K2_LAUNCHED)} (of {launches}) took the "
                         f"wrong design: {bad}")
    return "; ".join(f"M={m}: {c} of {src}"
                     for (src, m), c in sorted(K2_LAUNCHED.items(), key=lambda kv: kv[0][1]))


@_uncounted
def time_lm_prefill(tm, prompts: list, card: str) -> dict:
    """The full-width int8 ``lm_prefill`` alone, synchronised on the host
    clock, at one request's prompt (B=1) and the batch's (B=4), packed as
    ``tts_batch`` packs them: the mean of 5 after one warm-up.  Returns ms
    by M = B x prompt bucket."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.models.llm import lm_prefill

    cfg = tm.cfg.llm
    out = {}
    for batch in (prompts[:1], prompts):
        packs = [tm._pack_lm_prompt(p) for p in batch]
        b, p_bucket = len(batch), max(pk[3] for pk in packs)
        ids = np.zeros((b, p_bucket), np.int32)
        src = np.zeros((b, p_bucket), np.int32)
        for i, (pi, si, *_rest) in enumerate(packs):
            ids[i, : pi.shape[1]], src[i, : si.shape[1]] = pi[0], si[0]
        max_len = max(pk[5] for pk in packs)
        max_gen = min(((max_len + 63) // 64) * 64, cfg.max_seq_len - p_bucket)
        args = (tm._tensor(ids), tm._tensor(src), tm._tensor([pk[2] for pk in packs]))
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_prefill(tm.params["llm"], cfg, *args, max_gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[b * p_bucket] = sum(times[1:]) / len(times[1:])
        print(f"int8 lm_prefill alone B={b} P={p_bucket} (M={b * p_bucket}), max_gen {max_gen}: "
              f"{out[b * p_bucket]:.3f} ms (mean of 5, synchronised; runs "
              f"{', '.join(f'{x:.3f}' for x in times[1:])}) [{card}]")
    return out


def int8_path(card: str, bf16_llm: dict) -> tuple[list, list, list, dict]:
    """The int8 LM at full width: 2 zero-shot requests through ``Cosy2EU.tts``,
    then one ``tts_batch`` of 4 prompts with their own speakers.  Returns
    each LM decode's (batch, prompt bucket, steps), each flow call's (mel
    bucket, valid mel frames per K1 row), the launches of K1, K3, K4 and K2
    over the path, and ``lm_prefill``'s ms alone by M."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.ops import int8_matmul as i8
    from cosyvoice2_eu_torch.runtime.model import FLOW_TOKEN_BUCKETS, bucket_for

    cfg = TTSConfig()
    est = cfg.flow.estimator
    k1_per_flow = (2 + est.num_mid_blocks) * est.n_blocks * cfg.flow.cfm.n_timesteps
    n_layers = cfg.llm.backbone.num_layers
    per_prefill, per_step = 7 * n_layers, 7 * n_layers + 1  # 168, 169 at full width
    ratio, sr = cfg.token_mel_ratio, cfg.sample_rate
    t0 = time.perf_counter()
    model = cosy.load(config=cfg, seed=0, device="cuda", lm_quant="int8")
    torch.cuda.synchronize()
    tm = model._model
    print(f"int8 path: load(TTSConfig(), seed=0, device='cuda', lm_quant='int8') "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    prompt = _prompt(cfg, 3.0)
    texts = ["Bonjour, comment allez-vous ?", "Guten Morgen, wie geht es dir?"]
    batch_texts = ["Il fait beau aujourd'hui.", "Das Wetter ist heute schön.",
                   "Je voudrais un café, merci.", "Wo ist der Bahnhof, bitte?"]
    decodes, shapes = [], []
    torch.cuda.reset_peak_memory_stats()
    for f in _counters():
        f.launches = 0
    LAUNCHED.clear()
    K2_LAUNCHED.clear()

    def run(what, call, inputs):
        """One call; checks K1 and K2 launches and prints per-stage times."""
        before = (fa.flash_attention.launches, i8.int8_matmul.launches)
        tm.timer.reset()
        t0 = time.perf_counter()
        wavs, n_toks = call()
        wall = time.perf_counter() - t0
        stages = tm.timer.summary()
        k1, k2 = (fa.flash_attention.launches - before[0], i8.int8_matmul.launches - before[1])
        steps = tm.last_decode_steps
        p_bucket = max(tm._pack_lm_prompt(p)[3] for p in inputs)
        audio_s = sum(w.size for w in wavs) / sr
        ok = (k1 == k1_per_flow and k2 == per_prefill + per_step * steps
              and all(w.size == n * 2 * 480 and np.isfinite(w).all()
                      and float(np.abs(w).max()) > 1e-3 for w, n in zip(wavs, n_toks)))
        lm_ms = stages["lm_decode"]["total_s"] * 1e3
        print(f"{what}: B={len(inputs)}, prompt bucket {p_bucket} -> tokens {n_toks} in {steps} "
              f"decode steps, {audio_s:.2f} s audio; K2 launches {k2} (expected {per_prefill} + "
              f"{per_step} x {steps} = {per_prefill + per_step * steps}), K1 launches {k1} "
              f"(expected {k1_per_flow}); LM {lm_ms / steps:.2f} ms/step, "
              f"{lm_ms / sum(n_toks):.2f} ms/token, flow {stages['flow']['total_s'] * 1e3:.1f} "
              f"ms, HiFT {stages['hift']['total_s'] * 1e3:.1f} ms, wall {wall:.2f} s, RTF "
              f"{wall / audio_s:.3f} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"int8 path: {what} failed its checks")
        decodes.append((len(inputs), p_bucket, steps))
        totals = [len(p.flow_prompt_speech_tokens) + n for p, n in zip(inputs, n_toks)]
        t_mel = bucket_for(max(totals), FLOW_TOKEN_BUCKETS) * ratio
        shapes.append((t_mel, [n * ratio for n in totals] * 2))

    # zero-shot: the LM's prompt holds the 75 prompt speech tokens (bucket 128)
    for i, text in enumerate(texts):
        inputs = [model._frontend.frontend_zero_shot(text, prompt)]
        run(f"int8 request {i}", lambda: (list(model.tts(text, prompt, mode="zero_shot")[0]),
                                          [tm.last_n_tokens]), inputs)
    prompts = [model._frontend.frontend_zero_shot(text, _prompt(cfg, 3.0, seed))
               for seed, text in enumerate(batch_texts)]
    run("int8 tts_batch", lambda: (tm.tts_batch(prompts), tm.last_batch_tokens), prompts)
    launches = [f.launches for f in _counters()]
    k2_designs = _k2_designs({b * p for b, p, _ in decodes}, launches[3])
    print(f"int8 path: K1/K3/K4/K2 launches {launches} over {len(decodes)} LM decodes and flow "
          f"calls (K1 {_k1_design()}; K2 by M, as recorded at each launch: {k2_designs}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if launches[:3] != [k1_per_flow * len(decodes), 0, 0]:
        raise SystemExit("int8 path: K1/K3/K4 launches do not match its flow calls")
    prefill_ms = time_lm_prefill(tm, prompts, card)
    # reported, not gating: the JAX package pins the band only on the tiny config
    ids, src, total, p_bucket, _, _ = tm._pack_lm_prompt(prompts[0])
    valid = torch.arange(p_bucket)[None] < total
    rel, agree = _int8_logits_band(cfg, bf16_llm, "cuda", torch.as_tensor(ids).long(),
                                   torch.as_tensor(src).long(), valid)
    print(f"int8 path: full-width lm_training_hidden on the packed prompt of batch row 0 "
          f"({total} positions), int8 vs bf16 weights: max|dlogit| / max|logit| {rel:.4f}, "
          f"argmax agreement {agree:.3f} (reported; the band is pinned on the small config) "
          f"[{card}]")
    return decodes, shapes, launches, prefill_ms


def _flow_batch(flow_cfg, feat_lens, seed: int, device) -> dict:
    """A flow batch in the dataset's dict form (tokens = frames / ratio),
    from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ratio = flow_cfg.token_mel_ratio
    b, t_mel = len(feat_lens), max(feat_lens)
    feat_len = np.asarray(feat_lens, np.int32)
    batch = {
        "speech_token": rng.integers(0, flow_cfg.vocab_size, (b, t_mel // ratio)).astype(np.int32),
        "speech_token_len": feat_len // ratio,
        "speech_feat": (rng.standard_normal((b, t_mel, flow_cfg.output_size)) * 0.5
                        - 4.0).astype(np.float32),
        "speech_feat_len": feat_len,
        "embedding": rng.standard_normal((b, flow_cfg.spk_embed_dim)).astype(np.float32),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@_uncounted
def check_small_train_reference() -> None:
    """One flow train step on the card (K1 with LSE, K3, K4; fp32) against the
    CPU plain path, with the same parameters, batch and draws, on the small
    config of ``check_small_reference``; non-streaming and streaming.  The
    gradient leaves are read from Adam's first moment after the step
    (mu = 0.1 clip(g), accum_grad 1)."""
    import torch

    from cosyvoice2_eu_torch.config import TrainConfig, tiny_test_config
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.parallel.train_step import (
        init_train_state,
        make_flow_draws,
        make_flow_train_step,
    )
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map

    resolve_device("cuda")  # fp32 stays fp32: no TF32
    cfg = tiny_test_config().flow
    cfg = dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, attention_head_dim=64, num_heads=2))
    tc = TrainConfig(lr=1e-3, accum_grad=1)
    params = init_flow(torch.Generator(device="cpu").manual_seed(1), cfg)
    batch = _flow_batch(cfg, [180, 140], 5, "cpu")
    draws = make_flow_draws(torch.Generator(device="cpu").manual_seed(2), batch, cfg.output_size)
    # the loss within 1e-5 relative; each leaf within 1e-4 of its largest
    # entry (+1e-7 for leaves near zero): fp32, sums in another order
    for streaming in (False, True):
        out = {}
        for dev in ("cpu", "cuda"):
            tx = make_optimizer(tc)
            step = make_flow_train_step(cfg, tc, tx)
            state, metrics = step(init_train_state(tree_map(lambda x: x.to(dev), params), tx),
                                  {k: v.to(dev) for k, v in batch.items()},
                                  {k: v.to(dev) for k, v in draws.items()}, streaming=streaming)
            out[dev] = (float(metrics["loss"]), [x.cpu() for x in tree_leaves(state.opt_state["mu"])])
        (l_cpu, mu_cpu), (l_gpu, mu_gpu) = out["cpu"], out["cuda"]
        loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(mu_gpu, mu_cpu)]
        # the worst leaf's error as a share of its tolerance (<= 1 passes)
        worst = max(err / (1e-4 * peak + 1e-7) for err, peak in errs)
        ok = math.isfinite(l_gpu) and loss_err <= 1e-5 and worst <= 1.0
        print(f"train reference check (small config, fp32, streaming={streaming}, card vs CPU "
              f"plain path): loss {l_gpu:.6f} vs {l_cpu:.6f} (rel err {loss_err:.2e}, tol 1e-5); "
              f"{len(errs)} gradient leaves, each within 1e-4 x max|g| + 1e-7: the worst at "
              f"{worst:.3f} of its tolerance {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the card's train step disagrees with the plain CPU path")


def train_path(card: str) -> tuple[list, list]:
    """8 full-width flow training steps through ``Executor.train_epoch``.

    Returns the per-step records and the launches of K1, K3, K4 and K2 over the
    epoch (CV included)."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.config import TrainConfig, TTSConfig
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state, make_flow_train_step
    from cosyvoice2_eu_torch.train.executor import (
        Executor,
        latest_checkpoint,
        restore_train_state,
    )
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.train.train import make_flow_cv_fn, make_flow_step_fn
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_leaves
    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    dev = resolve_device("cuda")
    cfg = TTSConfig().flow
    est = cfg.estimator
    per_step = (2 + est.num_mid_blocks) * est.n_blocks
    tc = TrainConfig()
    t0 = time.perf_counter()
    params = init_flow(torch.Generator(device=dev).manual_seed(0), cfg)
    tx = make_optimizer(tc)
    state = init_train_state(params, tx)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"training path: init_flow(TTSConfig().flow, seed 0) on {dev}, {n_params / 1e6:.2f} M "
          f"parameters, fp32, {tc.optim} lr {tc.lr} accum_grad {tc.accum_grad}, "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    timer = StageTimer(sync=torch.cuda.synchronize)
    raw = make_flow_train_step(cfg, tc, tx, timer=timer)
    initial = [x.clone() for x in tree_leaves(params)]
    counters = _counters()
    steps = []

    def traced(state, batch, draws, streaming):
        before = [f.launches for f in counters]
        timer.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = raw(state, batch, draws, streaming=streaming)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = timer.summary()
        rec = {
            "step": state.step, "lens": batch["speech_feat_len"].tolist(),
            "chunk": est.static_chunk_size if streaming else 0, "loss": loss,
            "grad_norm": grad_norm, "ms": wall * 1e3,
            **{k: stages[k]["total_s"] * 1e3 for k in ("forward", "backward", "optimizer")},
            "frames": int(batch["speech_feat_len"].sum()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launched": [f.launches - n for f, n in zip(counters, before)],
            "unchanged": all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params), initial)),
        }
        steps.append(rec)
        print(f"train step {rec['step']}: B={len(rec['lens'])} T_mel={max(rec['lens'])} "
              f"chunk={rec['chunk']} loss {loss:.4f} grad_norm {grad_norm:.3f}; "
              f"{rec['ms']:.1f} ms (forward {rec['forward']:.1f}, backward {rec['backward']:.1f}, "
              f"optimizer {rec['optimizer']:.1f}), {rec['frames'] / wall:.0f} mel frames/s, "
              f"peak {rec['peak_gib']:.2f} GiB; K1/K3/K4/K2 launches {rec['launched']}; "
              f"parameters {'unchanged' if rec['unchanged'] else 'updated'} [{card}]")
        return state, metrics

    step_fn = make_flow_step_fn(raw_step=traced, cfg=cfg,
                                gen=torch.Generator(device=dev).manual_seed(1),
                                rng=np.random.default_rng(0))
    batches = [_flow_batch(cfg, TRAIN_SHAPES[i % 2], 100 + i, dev) for i in range(8)]
    cv = [_flow_batch(cfg, CV_SHAPE, 200, dev)]
    with tempfile.TemporaryDirectory() as model_dir:
        ex = Executor(tc, step_fn, make_flow_cv_fn(cfg), model_dir=model_dir)
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        state = ex.train_epoch(state, batches, cv)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = [f.launches for f in counters]
        info = latest_checkpoint(model_dir)
        template = init_train_state(init_flow(torch.Generator(device=dev).manual_seed(1), cfg), tx)
        restored = restore_train_state(model_dir, info, template)
        exact = restored.step == state.step and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(tree_leaves((restored.params, restored.opt_state)),
                            tree_leaves((state.params, state.opt_state))))
    losses_ok = all(math.isfinite(r["loss"]) for r in steps)
    multisteps_ok = [r["unchanged"] for r in steps[:4]] == [True, True, True, False]
    launches_ok = all(r["launched"] == [per_step] * 3 + [0] for r in steps)
    chunks = {r["chunk"] for r in steps}
    totals_ok = launches == [per_step * (len(steps) + len(cv)), per_step * len(steps),
                             per_step * len(steps), 0]
    print(f"training path: {len(steps)} steps + CV in {epoch_s:.2f} s, cv_loss "
          f"{info.get('cv_loss', float('nan')):.4f}; losses finite: {losses_ok}; parameters "
          f"unchanged after steps 1-3 and updated after step 4 (MultiSteps): {multisteps_ok}; "
          f"{per_step} launches each of K1 (with LSE), K3, K4 per step: {launches_ok}; chunks "
          f"{sorted(chunks)}; launches over the epoch K1/K3/K4/K2 {launches} (CV: K1 without "
          f"LSE); "
          f"checkpoint {info['tag']} restores bit-exactly: {exact}; peak memory "
          f"{max(r['peak_gib'] for r in steps):.2f} GiB [{card}]")
    if not (losses_ok and multisteps_ok and launches_ok and totals_ok and exact
            and chunks == {0, est.static_chunk_size}):
        raise SystemExit("the training path failed its checks")
    return steps, launches


@_uncounted
def time_training_kernels(steps: list, k1_launches: int, card: str) -> tuple[dict, dict, dict,
                                                                             list]:
    """K1 (with LSE), K3, K4, their plain versions and the library's forward
    and backward at every (lengths, chunk) the training path ran, fp32, and
    K1 without LSE at the CV batch; then bf16 at chunk 0 for comparison with
    K1's serving times.  Returns K1's times on the training path (CV
    included), K3's and K4's rows of the kernels line (means per launch of
    the path) and each step's (K1 + K3 + K4) ms per layer."""
    import torch
    import torch.nn.functional as F

    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.ops.masks import chunk_attention_mask

    h, d = 8, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    combos = [(tuple(lens), chunk, torch.float32)
              for lens, chunk in sorted({(tuple(r["lens"]), r["chunk"]) for r in steps})]
    combos += [(tuple(lens), 0, torch.bfloat16) for lens in TRAIN_SHAPES]
    timed = {}
    for lens, chunk, dtype in combos:
        b, t = len(lens), max(lens)
        k1 = _time_k1(lens, t, chunk, dtype, True, gen)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, lengths, chunk, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        mask = chunk_attention_mask(lengths, t, chunk)[:, None]
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        # the whole backward three ways: delta + K3 + K4, the plain version, SDPA's
        backward = dict(
            backward_ms=_cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, lengths,
                                                                chunk), 20),
            backward_plain_ms=_cuda_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, lengths, chunk), 5),
            backward_library_ms=_cuda_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do, retain_graph=True), 20))
        pairs = int(mask.sum().item()) * h  # visible (query, key) pairs of this run's data
        esize = q.element_size()
        io = 4 * b * h * t * d * esize + 2 * b * h * t * 4 + b * 4  # q, k, v, dO; lse, delta; lengths
        kern = {}
        for name, launch, grads, ops, out in (
                ("K3", lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, lengths, chunk), "q",
                 6 * d * pairs, b * h * t * d * esize),
                ("K4", lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, lengths, chunk),
                 "kv", 8 * d * pairs, 2 * b * h * t * d * esize)):
            ops_ms = ops / PEAKS[str(dtype)] * 1e3
            bytes_ms = (io + out) / H100_BYTES * 1e3
            # no library call computes dQ (or dK, dV) alone: SDPA's backward
            # computes all three and stands beside the whole backward above
            kern[name] = dict(
                ms=_cuda_ms(launch, 20),
                plain_ms=_cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, do, lse, delta, lengths, chunk, grads=grads), 5),
                library_ms=None, bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms, gflop=ops / 1e9, **backward)
        timed[(lens, chunk, dtype)] = dict(k1=k1, **kern)
        k3, k4 = kern["K3"], kern["K4"]
        print(f"K1/K3/K4 timing lengths={list(lens)} T={t} {str(dtype)[6:]} chunk={chunk} [{card}]: "
              f"K1+LSE {k1['ms']:.4f} ms ({k1['tflops']:.1f} TFLOP/s, {100 * k1['share']:.1f}% of "
              f"the bound; plain {k1['plain_ms']:.4f}, sdpa forward {k1['library_ms']:.4f}, bound "
              f"{k1['bound_ms'] * 1e3:.1f} us); K3 {k3['ms']:.4f} ms "
              f"(plain dQ {k3['plain_ms']:.4f}, bound {k3['bound_ms'] * 1e3:.1f} us, "
              f"{k3['gflop']:.2f} GFLOP); K4 {k4['ms']:.4f} ms (plain dK/dV {k4['plain_ms']:.4f}, "
              f"bound {k4['bound_ms'] * 1e3:.1f} us, {k4['gflop']:.2f} GFLOP); whole backward: "
              f"delta+K3+K4 {backward['backward_ms']:.4f} ms, plain "
              f"{backward['backward_plain_ms']:.4f} ms, sdpa {backward['backward_library_ms']:.4f}"
              f" ms; bounds at {'fp32 FMA' if dtype == torch.float32 else 'bf16 tensor-core'} "
              f"{PEAKS[str(dtype)] / 1e12:.0f} TFLOP/s and HBM {H100_BYTES / 1e12:.2f} TB/s")
    per_step = [timed[(tuple(r["lens"]), r["chunk"], torch.float32)] for r in steps]
    n = k1_launches // (len(steps) + 1)  # launches of each kernel per step (and per CV batch)
    cv = _time_k1(CV_SHAPE, max(CV_SHAPE), 0, torch.float32, False, gen)
    print(f"K1 timing (CV batch, no LSE) lengths={CV_SHAPE} fp32 chunk=0 [{card}]: kernel "
          f"{cv['ms']:.4f} ms ({cv['tflops']:.1f} TFLOP/s, {100 * cv['share']:.1f}% of the "
          f"bound), plain {cv['plain_ms']:.4f} ms, sdpa {cv['library_ms']:.4f} ms, bound "
          f"{cv['bound_ms'] * 1e3:.1f} us")
    k1_train = _weighted([(n, p["k1"]) for p in per_step] + [(k1_launches - n * len(steps), cv)])
    rows = [_kernel_row(name, "flash_attention_bwd.cu", f"flash_attention.py:{line}",
                        _weighted([(n, p[key]) for p in per_step]))
            for key, name, line in (("K3", "flash_attention_dq", 125),
                                    ("K4", "flash_attention_dkv", 172))]
    step_kernel_ms = [p["k1"]["ms"] + p["K3"]["ms"] + p["K4"]["ms"] for p in per_step]
    return k1_train, rows[0], rows[1], step_kernel_ms


def _time_k2(m: int, n: int, k: int, gen) -> dict:
    """K2, its plain version, ``torch._weight_int8pack_mm`` and ``F.linear``
    on bf16 weights at one (M, N, K), x in bf16 (device ms per call), after
    K2's output at this shape is held against the plain one (``err``; a
    disagreement ends the run) and the design it took noted.  Each
    call takes the next of enough weight copies to fill 100 MB, twice the
    L2, so the weights come from device memory as in the decode loop, where
    a token reads 363.7 MB of them.  The calls are captured in one CUDA
    graph and timed as its replay: at a few microseconds a launch, eager
    launches from Python would time the host, not the card."""
    import torch
    import torch.nn.functional as F

    from cosyvoice2_eu_torch.ops import int8_matmul as i8

    copies = max(2, math.ceil(100e6 / (n * k)))
    w_q = torch.randint(-127, 128, (copies, n, k), generator=gen, device="cuda",
                        dtype=torch.int8)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.rand((n,), generator=gen, device="cuda").to(torch.bfloat16)

    got, took = _k2_took(x, w_q[0])
    want = i8.int8_matmul_reference(x, w_q[0])
    err = (got - want).abs().max().item()
    tol = K2_TOL * want.abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        raise SystemExit(f"K2 disagrees with its plain version at the timed shape M={m} N={n} "
                         f"K={k}: max_abs_err={err:.3e} (tol {tol:.3e})")
    out = dict(err=err, source=took,
               ms=_graph_ms(lambda i: i8.int8_matmul(x, w_q[i]), copies),
               plain_ms=_graph_ms(lambda i: i8.int8_matmul_reference(x, w_q[i]), copies))
    try:  # the library's int8 weight-only matmul (scaled), where this PyTorch runs it on CUDA
        torch._weight_int8pack_mm(x, w_q[0], scale)
        torch.cuda.synchronize()
        out["library_ms"] = _graph_ms(lambda i: torch._weight_int8pack_mm(x, w_q[i], scale),
                                      copies)
        out["library_note"] = None
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        out["library_ms"], out["library_note"] = None, f"{type(e).__name__}: {str(e)[:160]}"
    w_bf16 = w_q.to(torch.bfloat16)  # F.linear on the same values as bf16 weights
    del w_q
    out["bf16_linear_ms"] = _graph_ms(lambda i: F.linear(x, w_bf16[i]), copies)
    del w_bf16
    ops = 2 * m * n * k
    nbytes = m * k * 2 + n * k + m * n * 4  # x bf16 and w int8 read once, y fp32 written once
    out.update(ops_ms=ops / H100_BF16_FLOPS * 1e3, bytes_ms=nbytes / H100_BYTES * 1e3,
               gflop=ops / 1e9, mb=nbytes / 1e6)
    out["bound_ms"] = max(out["ops_ms"], out["bytes_ms"])
    out.update(tflops=ops / out["ms"] * 1e-9, share=out["bound_ms"] / out["ms"])
    return out


@_uncounted
def time_int8_matmul(decodes: list, launches: int, card: str) -> dict:
    """K2 at every (M, N, K) the int8 path ran, weighted by its launches there.

    ``decodes`` holds each LM decode's (batch, prompt bucket, steps): the
    prefill runs the 7 projections of each layer at M = batch x bucket, each
    decode step runs them and the speech head at M = batch.  Returns the
    kernels line's mean per launch, with each shape's times under by_shape
    and each design's means per launch under by_design."""
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    n_layers = cfg.llm.backbone.num_layers
    counts: dict = {}

    def add(shape, c):
        counts[shape] = counts.get(shape, 0) + c

    for b, p_bucket, steps in decodes:
        for n, k, per_layer in _k2_shapes(cfg):
            if per_layer:  # a projection of every layer: at prefill and at each step
                add((b * p_bucket, n, k), n_layers * per_layer)
                add((b, n, k), n_layers * per_layer * steps)
            else:  # the speech head, once per step
                add((b, n, k), steps)
    if sum(counts.values()) != launches:
        raise SystemExit(f"K2's launches on the int8 path ({launches}) do not match its shapes "
                         f"({sum(counts.values())})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    parts, notes = [], set()
    for (m, n, k), c in sorted(counts.items()):
        r = _time_k2(m, n, k, gen)
        notes.add(r.pop("library_note"))
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        vs = r["ms"] / r["bf16_linear_ms"]
        print(f"K2 timing M={m} N={n} K={k} x bf16 ({r['source']}), weights cold, {c} launches "
              f"on the int8 path [{card}]: kernel {r['ms']:.4f} ms ({r['mb'] / r['ms']:.0f} "
              f"GB/s, {r['tflops']:.1f} TFLOP/s, {100 * r['share']:.1f}% of the bound), plain "
              f"{r['plain_ms']:.4f} ms, _weight_int8pack_mm {lib}, bf16 F.linear "
              f"{r['bf16_linear_ms']:.4f} ms (K2 {'beats it' if vs < 1 else 'loses'}, "
              f"{vs:.2f}x its time), bound {r['bound_ms'] * 1e3:.3f} us by "
              f"{'operations' if r['ops_ms'] >= r['bytes_ms'] else 'bytes'} ({r['gflop']:.3f} "
              f"GFLOP, {r['mb']:.3f} MB); output vs plain max_abs_err {r['err']:.3e} ok")
        parts.append((c, dict(r, m=m, n=n, k=k)))
    notes.discard(None)
    if notes:  # the library call is not timed on every shape: no library time at all
        print(f"K2 library_ms is null: torch._weight_int8pack_mm on CUDA failed here: "
              f"{'; '.join(sorted(notes))}")
        for _, r in parts:
            r["library_ms"] = None
    out = _weighted(parts)
    keys = ("ms", "plain_ms", "library_ms", "bf16_linear_ms", "bound_ms")
    out["by_shape"] = [{"m": r["m"], "n": r["n"], "k": r["k"], "source": r["source"],
                        "launches": c, **{key: r[key] for key in keys}} for c, r in parts]
    out["by_design"] = {}
    for source in sorted({r["source"] for _, r in parts}):
        mean = _weighted([(c, r) for c, r in parts if r["source"] == source])
        out["by_design"][source] = {"source": f"cosyvoice2_eu_torch/csrc/{source}",
                                    "launches": mean["launches"], "bound_by": mean["bound_by"],
                                    **{key: mean[key] for key in keys}}
    return out


def _print_prefill(by_shape: list, prefill_ms: dict, card: str) -> None:
    """K2's time summed over the launches of one prefill (7 projections x
    layers at M = B x prompt bucket), beside bf16 ``F.linear``'s and the
    bound's on the same shapes and ``lm_prefill``'s time alone."""
    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    n_layers = cfg.llm.backbone.num_layers
    for m, lm_ms in sorted(prefill_ms.items()):
        rows = {(r["n"], r["k"]): r for r in by_shape if r["m"] == m}
        per = [(n_layers * c, rows[(n, k)]) for n, k, c in _k2_shapes(cfg) if c]
        total = {key: sum(c * r[key] for c, r in per) for key in ("ms", "bf16_linear_ms",
                                                                 "bound_ms")}
        print(f"int8 prefill M={m}: K2 summed over its {sum(c for c, _ in per)} launches "
              f"{total['ms']:.3f} ms (bf16 F.linear on the same shapes "
              f"{total['bf16_linear_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms); lm_prefill "
              f"alone {lm_ms:.3f} ms [{card}]")


def _kernel_row(name: str, source: str, replaces: str, times: dict, **extra) -> dict:
    """One entry of the kernels line: ``source`` under ``cosyvoice2_eu_torch/csrc``
    replaces the TPU kernel at ``replaces`` ("file:line" under
    ``cosyvoice2_eu_tpu/ops/pallas``); times from ``_weighted``."""
    row = {"name": name, "route": "cuda", "source": f"cosyvoice2_eu_torch/csrc/{source}",
           "replaces": f"cosyvoice2_eu_tpu/ops/pallas/{replaces}",
           "launches": times["launches"], "max_abs_err": 0.0}
    row.update({k: times[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    row.update({k: v for k, v in times.items() if k.startswith("backward_")}, **extra)
    return row


def _sass_count(library, opcode: str) -> int:
    """How many SASS instructions of ``library`` start with ``opcode``
    (``cuobjdump -sass`` from the CUDA toolkit)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return sum(1 for line in sass.splitlines()
               if "*/" in line and line.split("*/", 1)[1].strip().startswith(opcode))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(REPO, "cosyvoice2_eu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout holding cosyvoice2_eu_torch/")
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)

    from cosyvoice2_eu_torch.ops import cuda_build
    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.ops import int8_matmul as i8

    t0 = time.perf_counter()
    sources = (fa.SM90_SOURCE, fa.SOURCE, fa.BWD_SOURCE, i8.SM90_SOURCE, i8.SOURCE)
    cuda_build.build(sources)  # one nvcc per source, in parallel
    for src in sources:
        cuda_build.load_library(src)
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for src, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  {src}: {line.strip()}")
    for src in (fa.SM90_SOURCE, i8.SM90_SOURCE):
        hgmma = _sass_count(cuda_build.library_path(src), "HGMMA")
        print(f"  {src}: {hgmma} HGMMA (wgmma) instructions in its SASS "
              f"{'ok' if hgmma else 'FAIL'}")
        if not hgmma:
            raise SystemExit(f"{src} holds no wgmma instruction")
    _record_launches(fa)
    _record_k2_launches(i8)

    worst = check_flash_attention()
    worst_dq, worst_dkv = check_flash_backward()
    worst_k2 = check_int8_matmul()
    check_small_reference()
    check_small_reference(lm_quant="int8")
    check_small_train_reference()
    tts_launches, shapes, flow_ms, bf16_llm = main_path(card)
    if fa.flash_attention_dq.launches or fa.flash_attention_dkv.launches or i8.int8_matmul.launches:
        raise SystemExit("the bf16 TTS path launched a backward kernel or K2")
    decodes, int8_shapes, int8_launches, prefill_ms = int8_path(card, bf16_llm)
    del bf16_llm
    steps, train_launches = train_path(card)

    k1_tts, calls_ms = time_flash_attention(shapes, tts_launches, card)
    per_call = tts_launches // len(shapes)
    for i, ((t, lens), f_ms) in enumerate(zip(shapes, flow_ms)):
        # K1's time at this call's shape, timed alone, times its launches per call
        print(f"request {i}: K1 at T={t}, {lens[0]} frames x {per_call} launches is an estimated "
              f"{per_call * calls_ms[i]:.1f} ms of {f_ms:.1f} ms flow [{card}]")
    k1_int8, _ = time_flash_attention(int8_shapes, int8_launches[0], card)
    k2_times = time_int8_matmul(decodes, int8_launches[3], card)
    k2 = _kernel_row("int8_matmul", i8.SOURCE, "int8_matmul.py:31", k2_times,
                     bf16_linear_ms=k2_times["bf16_linear_ms"], by_shape=k2_times["by_shape"],
                     by_design=k2_times["by_design"])
    k2["max_abs_err"] = worst_k2
    _print_prefill(k2_times["by_shape"], prefill_ms, card)
    k1_train, k3, k4, step_kernel_ms = time_training_kernels(steps, train_launches[0], card)
    if [k3["launches"], k4["launches"]] != train_launches[1:3]:
        raise SystemExit("K3/K4 launches do not match the training path")
    # K1's times are means per launch over the paths; each path's stand beside them
    paths = {"tts": k1_tts, "int8": k1_int8, "train": k1_train}
    # eager_ms: the same launches made eagerly from Python, beside the replayed ms
    keys = ("launches", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # each design's mean per launch: bf16 (wgmma) on the serving paths, fp32 (FMA) in training
    serving = _weighted([(p["launches"], p) for p in (k1_tts, k1_int8)])
    designs = {"bfloat16": (fa.SM90_SOURCE, serving), "float32": (fa.SOURCE, k1_train)}
    k1 = _kernel_row("flash_attention_fwd", fa.SM90_SOURCE, "flash_attention.py:71",
                     _weighted([(p["launches"], p) for p in paths.values()]),
                     by_path={name: {k: p[k] for k in keys} for name, p in paths.items()},
                     by_dtype={name: {"source": f"cosyvoice2_eu_torch/csrc/{src}",
                                      **{k: p[k] for k in keys}}
                               for name, (src, p) in designs.items()})
    k1["max_abs_err"], k3["max_abs_err"], k4["max_abs_err"] = worst, worst_dq, worst_dkv
    per_step = train_launches[1] // len(steps)
    for r, kern_ms in zip(steps, step_kernel_ms):
        # K1+K3+K4 at this step's shape and chunk, timed alone, times their launches per step
        print(f"train step {r['step']}: K1+K3+K4 at lengths={r['lens']} chunk={r['chunk']} x "
              f"{per_step} launches is an estimated {per_step * kern_ms:.1f} ms "
              f"({100 * per_step * kern_ms / r['ms']:.0f}%) of {r['ms']:.1f} ms [{card}]")
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
