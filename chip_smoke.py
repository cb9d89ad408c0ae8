#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. print the card's name and power limit, build the CUDA kernels from
     ``cosyvoice2_eu_torch/csrc`` (one nvcc per source, in parallel) and
     print the build time, ptxas's register, spill and shared-memory lines
     (it fails on a spill in K2's decode design, in K1's fp32 source or in
     K3/K4's), the count of ``HGMMA`` (wgmma) instructions in the libraries
     of K1's bf16 design and K2's prefill design and of ``HMMA``
     (``mma.sync``) instructions in those of K1's fp32 design and K3/K4 (it
     fails at 0 in any), and the blocks of K1 fp32, K3 and K4 resident on an
     SM (it fails below 3 for K1, 2 for K3/K4) with the waves of their grids
     at the training path's two batches;
  2. kernel checks against the plain PyTorch versions on the card: K1
     (flash-attention forward, O and LSE; bf16 by wgmma, fp32 in 3xTF32 on
     ``mma.sync``) and K3/K4 (its backward, 3xTF32 on ``mma.sync``), every
     row, at B=2 ragged shapes and the training path's two batches, K1 also
     at the edges of its tiles (T 1 to 200: bf16 128-row, fp32 64-row blocks
     over 32-key tiles), with a row of length 0, fp32 K1 with a second
     launch that must be bit-equal, bf16 K1 at the int8 batch's B=8 (640
     blocks, several waves),
     K3/K4 also at the edges of their 64-row tiles (T 1 to 129, and a row of
     length 0) with a second launch that must be bit-equal, K1 ->
     K3/K4 also against the fully plain forward and backward; K2 (the int8
     matmul) at every (N, K) of the int8 LM, M 1 to 512, bf16 and fp32 x,
     plus a ragged K, in bf16 at the edges of its wgmma design (M 9 to 512,
     N 128 and 6564, K 896 and 4864), and in bf16 and fp32 at the edges of
     its decode design (M 1 to 8, N 33, 128 and 6564, K 16 to 8192: every
     cluster size 1 to 8), and at every (N, K) of the Qwen3-0.6B backbone's
     int8 LM (bf16 and fp32 x at M 1 to 8, bf16 at M 9, 64, 130 and 512),
     each case with the design it took, which must
     be the one ``design`` names; two launches of the decode design on the
     same inputs must be bit-equal;
  3. reference checks on a small config, on the card (kernels included)
     against the plain CPU path with the same weights and draws: the TTS
     pipeline in fp32, unquantized and with ``lm_quant="int8"`` (its decode
     on K2's decode design in fp32; then also equal int8 codes, K2's launch
     count and the int8-vs-fp32 logits band), and one flow train step;
     then bistream (the head's FILL and EOS bias raised by ``SMALL_BIAS``):
     ``lm_inference_bistream`` tokens equal and ``tts_stream_text`` chunks
     equal in length with audio within 1e-3, unquantized and int8 (equal
     codes), and one LM, one LoRA and one DPO train step (loss within 1e-5
     relative, every gradient leaf within 1e-4 x max + 1e-7); then the v1
     model (CosyVoice-300M's layout, fp32, K1's fp32 design, estimator
     heads of 64) on a small config: equal ``lm_decode`` tokens, ``tts``
     audio within 1e-3 and a streamed ``vc`` in chunks of equal count and
     length within 1e-3, K1 launched 2 x n_blocks x stages a flow call;
  4. TTS path: ``load(config=TTSConfig(), seed=0, device="cuda")`` at the
     published widths (random weights) answers 2 requests (flow buckets
     T 1536 and 1280); checks the audio
     and that each flow call launched K1 560 times; per-stage times;
  5. int8 path: the same with ``lm_quant="int8"``: 1 request, then one
     ``tts_batch`` of 4 prompts; checks the audio, 168 + 169 x steps K2
     launches per LM decode and 560 K1 launches per flow call, and from
     the record of each K2 launch that every prefill launch took the wgmma
     design and every decode launch the decode one; per-stage times, RTF, the
     int8-vs-bf16 logits on one packed prompt, and ``lm_prefill`` alone at
     one request's and the batch's prompt;
  5b. stream phase: on a small config, streams on the card against the
     plain CPU path (the chunk-cached path, the recompute path and a
     rollover past a 100-token cap: equal chunks, audio within 1e-3) and
     the cached flow's mel against the recompute on the card for 5 seeds;
     at the published widths one ``Cosy2EU.stream`` request per path
     (``cached_stream=False``, then the default) and one ``Cosy2EU.tts``,
     each on a fresh ``load(seed=0)``, which must give the same tokens,
     tokens x 960 samples in finite, non-silent chunks and 560 K1 launches
     per flow call (recompute: one per chunk; cached: 2), with time to
     first audio, each chunk's wall time, the steady chunk's median, RTF,
     LM ms/token, session bytes (held equal to what the allocator is
     asked for across a session's allocation on the card) and peak
     memory; one int8 cached stream (K2 168 + 169 x steps, each launch
     on its design); then K1 checked at every (lengths, T, chunk) the
     phase gave it;
  5c. the checkpoint, long-utterance and vc paths, each with the counts set
     to 0 before it and read
     after it (K1 560 times a flow call, each launch of its bf16 design, no
     K2, K3 or K4), then K1 checked at every shape each gave it (T up to
     2048): a small-config check first (``StreamSession`` through
     ``_finalize_full`` past a flow bucket cut to 128 tokens, rolling over
     and escalating; a session drained at its cap; ``vc`` with and without
     streaming; card vs CPU, equal chunks, audio within 1e-3); the
     checkpoint round trip (the seed-0 model written as reference state
     dicts and a speaker store, ``load(model_dir=...)``: equal LM and flow
     parameters, HiFT within 1e-6, the stored prompt, equal tokens and
     audio within 1e-3 of the in-memory model); the long utterance (a 20 s
     prompt and a 27-byte text, ~540 tokens: 1040 past the largest flow
     bucket: ``Cosy2EU.tts``
     through the ``StreamSession`` fallback with a rollover and an escalated
     chunk, ``Cosy2EU.stream`` rolling over, and the recompute path over the
     same tokens; equal tokens, tokens x 960 samples); ``vc`` of the stream
     phase's 160 tokens with and without streaming;
  5d. the prompt frontend (counts set to 0 before its requests, read after):
     16-bit PCM prompts written from a seeded signal (16 kHz mono 3 s and
     30 s, 48 kHz stereo 3 s); the FSQ speech tokenizer and CAM++ at the
     published widths from a seeded generator on the card, held against
     the CPU on the 3 s prompt (prompt mel, whisper log-mel, z, codes
     differing only within ``FSQ_EPS`` of a rounding boundary, x-vector);
     ``extract_prompt`` timed per stage at each prompt (first call, median
     of 5 warm); then ``Cosy2EU(load(seed=0, download=False)...)`` on the
     3 s wav: a zero-shot ``tts`` with ``text_frontend=True`` and an
     instruct2 ``stream`` that must hit the prompt cache, each with tokens,
     RTF, the stage split and the frontend's share, time to first audio,
     peak memory and K1 560 times a flow call;
  5e. the serving engine (counts set to 0 before the phase, read after):
     on a small config, ``slots_decode`` over 4 slots and the batched
     steady chunk ``_stream_chunk_batch`` over two sessions at different
     cursors on the card against the CPU; at the published widths
     ``TTSEngine(n_slots=4, chunk_steps=25, max_cache=1024, max_gen=640)``
     takes 5 bf16 requests at once (one waits staged for a slot), then
     ``serve_stdlib`` over ``EngineAPI`` on 127.0.0.1 answers a zero-shot
     POST of the 3 s wav, then a fresh int8 model's engine takes 2 requests
     on 4 slots (every batched group padded): per request time to first
     audio, steady chunk median, wall and tokens, per run aggregate RTF,
     ms per 4-row decode step, stage totals, batched rounds and peak
     memory; gates: tokens x 960 samples of finite, non-silent audio, a
     batched first and a batched steady round in each run, PCM of whole
     tokens, K1 560 times a flow call (the batched first emissions on 4
     rows), K2 168 times a ``prefill_row`` and 169 a decode step at M = 4;
     then one ``tts_batch`` of 6 short prompts (HiFT on one sub-batch of 6
     rows): tokens x 960 samples, K1 560 times; K1 checked at every shape;
  5f. bistream, each request with the counts set to 0 before it and read
     after (the head's FILL and EOS bias raised by ``PROTOCOL_BIAS``, since
     random weights never ask for text): at the published widths (the
     Qwen2 BlankEN LM, bf16, the 3 s prompt) one ``Cosy2EU.stream_text``
     request fed ``STREAM_TEXT`` word by word, one
     ``TTSModel(use_bistream=True).tts`` and one int8 ``stream_text``; then
     ``load(backbone="hf:Qwen/Qwen3-0.6B")`` (28 layers, hidden 1024, head
     dim 128, q/k norms, random weights): one bf16 and one int8
     ``stream_text``.  Gates: tokens x 960 samples of finite, non-silent
     audio; K1 560 times a flow call; under int8 K2 168 launches an extend
     and 169 a decode step (Qwen3: 196 and 197), extends at M = 64 on the
     wgmma design, steps at M = 1 on the decode design.  Prints time to
     first audio, each chunk's wall time and the steady median, RTF, LM
     ms/token, the extends and decode calls, peak memory;
  5g. the v1 family (counts set to 0 before each request, read after):
     ``load_v1(config=TTSV1Config(), seed=0, device="cuda")`` at
     CosyVoice-300M's published widths (random weights; a 6-block
     1024-wide text encoder, a 14-block 1024-wide LM, the 6-block 512-wide
     flow encoder, the (256, 256) U-Net, HiFT at 22.05 kHz), all fp32:
     1 request, 1 streamed request (the growing hop, the mel crossfade)
     and a ``vc`` of the first request's tokens, from a synthetic 3 s
     prompt (150 tokens, 258 mel frames).  Gates: finite, non-silent audio
     of mel frames x 256 samples, K1 640 times a flow call, every launch on
     its fp32 design; prints LM ms/token, flow ms a call, HiFT ms, RTF, the
     first chunk's latency and peak memory; then K1 checked at each flow
     call's (2, 8, T, 64) and (2, 8, ceil(T / 2), 64);
  5h. the evaluation harness (counts set to 0 before it, read after):
     ``run_eval.evaluate_model`` over ``Cosy2EU.tts`` at ``TTSConfig()``
     (random weights, seed 0; the frontend phase's seeded FSQ tokenizer and
     CAM++ on the card) on 4 utterances of 2 speakers written from seeded
     harmonics, SECS on the card's CAM++.  Gates: 4 rows, none failed; rtf,
     mcd, mcd_rel, lsd and secs finite; the pitch metrics finite unless a
     side has under 5 voiced frames (then NaN, as the JAX package's guard);
     K1 560 times a flow call.  Prints each sample's synthesis ms and
     metric host ms, and the summary;
  5i. (run after 5d) native checkpoints, the ONNX graph executor and the ASR decoder, each
     with the counts set to 0 before it and read after: the seed-0 model at
     ``TTSConfig()`` written by the trainer's ``save_checkpoint`` (HiFT as a
     GAN whole tree with the published-width discriminators), extracted by
     ``tools/extract_for_inference`` with a run id and loaded by
     ``load(model_dir=..., final=False, *_run_id=...)``: the extracted trees
     bit-equal to the written ones, every parameter ``torch.equal`` to the
     in-memory ``load(seed=0)``'s, one ``Cosy2EU.tts`` with its tokens and
     audio within 1e-3, K1 560 a flow call; bytes written and read, load
     seconds; then the JAX package's orbax checkpoint committed under
     ``tests/data/`` read bit-equal to its ``.npz`` (the reader and the
     system's libzstd); the speech tokenizer and CAM++ ONNX graphs written
     at the default ``SpeechTokenizerConfig`` / ``CAMPPlusConfig`` widths
     (this script's own copy of the tests' graph writer), a 3 s prompt
     through ``load_frontend_fns`` structurally and under
     ``COSY2EU_ONNX_EXECUTOR=1``: equal FSQ codes, x-vector cosine at least
     0.9999, each way's ms a prompt second; the ASR decoder at
     ``AsrDecoderConfig()`` (an n-best of 10 x 20 tokens over 75 frames,
     the batched forward and 20 one-step calls) and ``moe_ffn`` (8 experts,
     top 2, 256 -> 2048) on the card against the CPU within 1e-5 relative;
     the last two launch no kernel;
  6. training path: 8 flow-matching steps at the published widths through
     ``Executor.train_epoch`` (``TrainConfig()`` defaults, accum_grad 4),
     then CV and an end-of-epoch checkpoint; checks finite losses, the
     MultiSteps update at step 4, 56 launches of K1 (with LSE), K3 and K4
     per step, and a bit-exact checkpoint round trip; per-step times;
  6b. the speech LM's training: the Qwen2-0.5B LM in fp32 with
     ``TrainConfig()``'s optimizer through the trainer's LM step functions,
     4 steps on B = 2 batches from ``build_lm_batch`` (both layouts), a CV
     batch, 2 LoRA steps (rank 8) and 2 DPO steps; finite losses and
     gradient norms, the update at step 4, no kernel launched; forward /
     backward / optimizer ms per step and peak memory;
  6c. HiFT GAN training (counts set to 0 before it, read after): first, on
     the card against the plain CPU path, one discriminator turn and one
     generator turn of ``make_gan_steps`` on the tiny HiFT with the
     full-width discriminators (2 crops of hop x 8 samples, the same
     weights and draws, TF32 off; every loss within 1e-5 relative, every
     gradient leaf within 1e-4 x max + 1e-7); then at the published widths
     (``HiFTConfig()``, the MPD and MRD discriminators) 174 in-memory
     samples of 3-8 s (a harmonic signal of known F0) through the port's
     pipeline with ``gan=True`` (24480-sample crops, the host mel at fmax
     8 kHz, the native YIN, ``dynamic_batch`` at 3000 frames: 58 crops a
     batch) and 3 batches through ``train_gan.train_gan``, each a
     discriminator turn then a generator turn, and its checkpoint.  Gates:
     finite losses and no skipped update, both parameter trees moved, every
     crop's median voiced YIN F0 within 5 Hz of its signal's, no kernel
     launched.  Prints the batch size, each turn's ms, the host featurize
     ms per crop (mel and YIN apart) and peak memory;
  6d. the trainer's command line from the batch iterators down to the
     checkpoint, each run with its counts set to 0 before it and read
     after: ``train.run`` (the body of ``train.main`` after the parquet
     opener) on in-memory samples (French text, a harmonic signal of 4-12
     s, random speech tokens at 25 Hz, 192-d embeddings) through the
     pipeline with ``prefetch`` on: ``--model flow`` at ``TTSConfig().flow``
     for an epoch of 4 steps (accum_grad 4: one emitting step), CV and the
     epoch's checkpoint, then ``--resume`` to a second epoch, then
     ``--model llm`` (Qwen2-0.5B, fp32) for 2 steps.  Gates: finite losses
     and no skipped update, the step counts, the resume continuing at
     epoch 1, a ``StragglerGuard`` beat a step, K1 (with LSE), K3 and K4 56
     launches each a flow step and K1 56 a CV batch, every launch on its
     fp32 design, no launch in the LM's runs; then K3/K4 checked against
     their plain version at every flow step's shape.  Prints the
     pipeline's ms a batch beside each step's ms, and peak memory;
  6e. several processes: (a) a world-1 NCCL group in this process, one
     data-parallel flow step at ``TTSConfig().flow`` on the training path's
     B=4 batch against the plain step under the same draws; (b) 2 spawned
     ranks sharing the card over gloo (NCCL takes one rank a GPU), the same
     batch split 2 / 2: a DP step and a ``--fsdp 2`` step, each held to the
     one-process step (loss within 1e-5 relative, parameters and Adam's
     first moment within 1e-4 x max + 1e-7), 56 launches each of K1, K3
     and K4 a step and rank; (c) the same 2 ranks, Qwen2-0.5B split tp=2:
     fp32 prefill logits against tp=1's within 1e-5 x max|logits| with the
     K/V kept in fp32, and within 1e-3 x max|logits| through the bf16 KV
     cache ``lm_prefill`` writes (its roundings turn the sums' reordering
     into steps of 2^-8: ``cosyvoice2_eu_torch/tools/tp_fp32_drift.py``),
     and 16 decoded tokens equal to tp=1's, bf16 and int8 ms a step beside tp=1's (the ranks
     share the card: not a scaling figure), K2 168 + 169 x steps a rank at
     the int8 slices, prefill on the wgmma design and steps on the decode
     design.  The kernels are built before the ranks start; the ranks
     print nothing, and a failing or hung rank fails the run;
  6f. (after 6e) serving a tensor-parallel model: the same 2 ranks, the
     published-width weights of ``load(seed=0)`` with the LM in fp32 (fp32
     K/V) split tp=2 and the bf16 flow and fp32 HiFT whole on each, behind
     a ``TTSEngine`` (4 slots, at most 64 generated tokens) serving 2
     concurrent requests from process 0 while process 1 follows its LM
     calls, then the same requests through a tp=1 engine on process 0:
     every slot's tokens equal on both ranks and at tp=1, audio within
     1e-3 of tp=1's, the follower ended on close, K1 560 times a flow call
     on process 0 and none on process 1; ms a 4-row step on each rank and
     at tp=1;
  6g. export: ``export_tts_stages`` of the published-width bf16 flow at
     token bucket 256, the ``.pt2`` loaded back and called: K1
     56 times a call (counts set to 0 before it, read after), the output
     within 2^-7 x max|eager| of the eager estimator (bit-equal expected);
     export seconds and bytes;
  6h. the store of kernel libraries: a fresh process with
     ``COSY_AOT_CACHE`` at a new directory under ``_build/`` runs
     ``cosy2-eu warmup --export-store DIR --prompt-seconds 3`` (nvcc builds
     every library there); a second fresh process, nvcc hidden (not on
     ``PATH``, ``CUDA_HOME`` at a directory that does not exist), serves
     one ``Cosy2EU.tts`` from that store: it must build nothing, find no
     nvcc, give tokens x 960 samples and launch K1 560 times a flow call;
     each process's seconds from its launch to its first audio;
  6i. ``tools/profile_stages.py`` at the published widths with a trace of
     one decode chunk and one flow call: each stage's ms, the card's busy
     share of each traced block and its five kernels with the most device
     time (a measurement: its launches do not count);
  7. kernel timings at the shapes of the paths: K1 on all of them (with
     TFLOP/s on the visible pairs and the share of the bound, and its
     output at each timed shape held against the plain one; the v1 path's
     fp32 shapes beside SDPA, the plain version and the 3xTF32 bound), K3 and K4 at
     the training path's shapes (CUDA-graph replay, eager beside it), with
     the bound of fp32 work in 3xTF32 (three TF32 products at the tensor
     cores' 495 TFLOP/s) and the fp32 FMA units' bound beside it, K2 at every
     (M, N, K) of the int8 path and stream with its weights cold in L2 (its output
     held against the plain one, with TFLOP/s and the share of the bound,
     beside its plain version, ``torch._weight_int8pack_mm`` where the
     card's PyTorch runs it, ``F.linear`` on the bf16 weights and, at the
     decode shapes, the FMA design ``int8_matmul.cu`` that served them
     before), K2's time summed over one prefill beside ``lm_prefill``'s,
     and summed over one decode step at M = 1 and 4 beside the FMA
     design's, ``F.linear``'s and the bound.
The run's seconds are printed with the LM's ms/token in ``profile_stages``
(how fast the host was), then ``{"phase_seconds": {...}}``: each phase's
host seconds, a phase that runs in several places summed.  The line before
the last is the kernels JSON (K1, K2, K3, K4): K1's times are means per launch over
the paths (each path's under ``by_path``, each design's under ``by_dtype``:
bf16 on the TTS, int8, stream, checkpoint, long, vc, frontend, native,
engine, tts_batch6, bistream, qwen3, tp_serving and export paths, fp32 on the training path, the
trainer command line's "cli", the v1 path's "v1" and the parallel
phase's "parallel"; the eval phase's "eval" among the bf16 ones), K2's over
the shapes of the int8 path, the int8 stream, the int8 engine, the int8
bistream requests, Qwen3's included, and the tp=2 slices (each under ``by_shape``,
with ``bf16_linear_ms`` and at decode ``fma_ms``; each design's under
``by_design``: the wgmma one at prefill, the decode one at decode); K3's
and K4's times are means per launch over the training path, the
command line's and the parallel phase's (each path's under ``by_path``), their
``plain_ms`` time the plain dQ and dK/dV alone, their
``library_ms`` is null (no library call computes one of them alone), and
``backward_*ms`` time the whole backward as delta + K3 + K4, the plain
version and SDPA's; ``fma_bound_ms`` beside K1's and K3/K4's ``bound_ms``
is the bound on the FMA units.  The last line is
``{"ok": true, "device": {...}}``.  The script imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores (FMA), H100 SXM data sheet
H100_BYTES = 3.35e12      # HBM3 bandwidth
# The least time for one input type's work at its accuracy: bf16 on the tensor
# cores; fp32 in 3xTF32 (three TF32 products per fp32-accurate product), the
# fastest fp32-accurate way on this card.  The fp32 FMA units' bound
# (H100_FP32_FLOPS) is printed beside it.
PEAKS = {"torch.float32": H100_TF32_FLOPS / 3, "torch.bfloat16": H100_BF16_FLOPS}


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


def _k1_default_cases() -> list:
    """K1's check cases: (lengths, T, dtypes, chunks, label)."""
    import torch

    both = (torch.bfloat16, torch.float32)
    cases = [(lens, max(lens), both, (0, 50), "")
             for lens in _check_cases((128, 384, 1280, 1536, 2048))]
    cases += [([t, max(1, (3 * t) // 5)], t, (torch.bfloat16,), (0, 50), " edge")
              for t in (1, 64, 65, 127, 129, 200)]
    cases += [([t, max(1, (3 * t) // 5)], t, (torch.float32,), (0, 50), " edge")
              for t in (1, 31, 32, 33, 63, 64, 65, 127, 129, 200)]
    cases.append(([200, 0], 200, both, (0,), " edge"))
    # the v1 estimator's fp32 shapes of a 3 s prompt and ~6 s of speech: T and ceil(T / 2)
    cases += [([t, t], t, (torch.float32,), (0,), " v1") for t in (774, 387)]
    # the int8 path's tts_batch of 4 (CFG doubles the rows) in its mel bucket
    cases.append(([1150, 1270, 730, 1190] * 2, 1280, (torch.bfloat16,), (0, 50), " int8 batch"))
    return cases


@_uncounted
def check_flash_attention(cases=None) -> float:
    """K1 against its plain version at the shapes of both paths, with and
    without LSE; O and LSE compared on every row (pad rows included, which
    K3 and K4 read).  Both designs also at the edges of their tiles (T 1 to
    200: bf16's 128-row blocks, fp32's 64-row blocks over 32-key tiles), with
    a row of length 0 (at chunk 0 the mean of V over all T keys on both
    sides); bf16 at the int8 batch's shape (B=8 at T 1280: 640 blocks, more
    than one wave of the card).  Every fp32 case launches twice, and the two
    outputs must be bit-equal (each block owns its outputs).  ``cases``
    replaces these with (lengths, T, dtypes, chunks, label) of its own (the
    stream phase's flow calls).  Returns the worst O error."""
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    h, d = 8, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if cases is None:
        cases = _k1_default_cases()
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
                    again = ""
                    if dtype == torch.float32:
                        second = fa.flash_attention(q, k, v, lengths, chunk, return_lse=with_lse)
                        pairs = zip(got, second) if with_lse else [(got, second)]
                        same = all(torch.equal(a, b) for a, b in pairs)
                        again, ok = f", a second launch bit-equal: {same}", ok and same
                    print(f"K1{what} check lengths={lens} T={t} {str(dtype)[6:]} chunk={chunk} "
                          f"lse={with_lse}, every row: max_abs_err={err:.3e} (tol {tol:.3e}) "
                          f"lse_err={lse_err:.3e} (tol {K1_LSE_TOL:g}){again} "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"K1 disagrees with its plain version at lengths={lens}")
                    worst = max(worst, err)
    return worst


def tf32_occupancy() -> None:
    """Blocks of K1's fp32 design, K3 and K4 resident on one SM (CUDA's
    occupancy calculator on the built kernels), which must be at least what
    their launch bounds ask (3 for K1, 2 for K3 and K4), and the waves of
    their grids (one block per 64-row tile and b*h) at the training path's
    two batches."""
    import ctypes

    import torch

    from cosyvoice2_eu_torch.ops import cuda_build
    from cosyvoice2_eu_torch.ops import flash_attention as fa

    fwd = cuda_build.load_library(fa.SOURCE).cosy_flash_attention_fwd_occupancy
    fwd.argtypes = [ctypes.POINTER(ctypes.c_int)]
    bwd = cuda_build.load_library(fa.BWD_SOURCE).cosy_flash_attention_bwd_occupancy
    bwd.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fwd.restype = bwd.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = (("K1", fa.SOURCE, 3, {"fp32": fwd}),
               ("K3", fa.BWD_SOURCE, 2, {"fp32": functools.partial(bwd, 0, 0),
                                         "bf16": functools.partial(bwd, 0, 1)}),
               ("K4", fa.BWD_SOURCE, 2, {"fp32": functools.partial(bwd, 1, 0),
                                         "bf16": functools.partial(bwd, 1, 1)}))
    for name, src, least, queries in kernels:
        per_sm = {}
        for dtype, query in queries.items():
            n = ctypes.c_int(0)
            err = query(ctypes.byref(n))
            if err:
                raise SystemExit(f"{name}: occupancy query failed: CUDA error {err}")
            per_sm[dtype] = n.value
        waves = [f"lengths={lens}: {len(lens) * 8 * -(-max(lens) // 64)} blocks, "
                 f"{len(lens) * 8 * -(-max(lens) // 64) / (per_sm['fp32'] * sms):.2f} waves"
                 for lens in TRAIN_SHAPES]
        ok = min(per_sm.values()) >= least
        print(f"  {src} {name}: "
              + ", ".join(f"{n} blocks an SM in {dtype}" for dtype, n in per_sm.items())
              + f" (at least {least}), x {sms} SMs; {'; '.join(waves)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name}: fewer than {least} blocks fit on an SM")


@_uncounted
def check_flash_backward(cases=None) -> tuple[float, float]:
    """K3 and K4 against their plain version: B=2 ragged at T from 128 to
    2048, the training path's two batches exactly, and the edges of the
    kernels' 64-row tiles (T 1 to 129, and a row of length 0); fp32 and bf16,
    chunk 0 and 50 (``cases`` replaces these with (lengths, dtypes, chunks)
    of its own, the shapes of the trainer's command line).  dQ is compared on every query row (pad rows included),
    dK/dV on every key, and dK/dV must be exactly 0 on keys at or past
    length[b].  Two comparisons per case: both sides take K1's O and LSE (K3
    and K4 alone), and, in fp32, the port's chain (K1, delta, K3, K4) against
    the fully plain chain (the plain forward's O and LSE into the plain
    backward).  A second launch of K3 and of K4 on the same inputs must be
    bit-equal to the first.  Returns the worst dQ and dK/dV errors of the
    first comparison.  Also, with the default cases: the forward under
    autograd equals the inference launch."""
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    # fp32: the kernels and the plain version compute in fp32 and differ only
    # in summation order, 1e-4 x max(1, max|want|).  bf16: both round the same
    # fp32 result once, so one bf16 ulp, 2^-7 of the largest output.
    h, d = 8, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = {"dq": 0.0, "dkv": 0.0}
    both = (torch.float32, torch.bfloat16)
    defaults = cases is None
    if defaults:
        cases = [(lens, both) for lens in _check_cases((128, 384, 740, 1480, 2048))]
        # the edges of the 64-row tiles; at T = 1 the one visible key makes dQ
        # and dK zero up to rounding, which a tolerance relative to bf16's
        # largest output cannot hold, so that case runs in fp32 only
        cases += [([1, 0], both[:1])]
        cases += [([t, (3 * t) // 5], both) for t in (63, 64, 65, 127, 129)] + [([200, 0], both)]
        cases = [(lens, dtypes, (0, 50)) for lens, dtypes in cases]
    for lens, dtypes, chunks in cases:
        b, t = len(lens), max(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for dtype in dtypes:
            q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            for chunk in chunks:
                o, lse = fa.flash_attention(q, k, v, lengths, chunk, return_lse=True)
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, lengths, chunk)
                # K3 and K4 again on the same inputs: each block owns its outputs
                delta = (do.float() * o.float()).sum(-1)
                again = (fa.flash_attention_dq(q, k, v, do, lse, delta, lengths, chunk),
                         *fa.flash_attention_dkv(q, k, v, do, lse, delta, lengths, chunk))
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
                bit_equal = all(torch.equal(a, g) for a, g in zip(again, got))
                ok = ok and zero_past and bit_equal
                print(f"K3/K4 check lengths={lens} T={t} {str(dtype)[6:]} chunk={chunk}, every "
                      f"row and key: max_abs_err {'; '.join(parts)}; dK=dV=0 past length: "
                      f"{zero_past}; second launch bit-equal: {bit_equal} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"K3/K4 disagree with their plain version at lengths={lens}")
    if not defaults:
        return worst["dq"], worst["dkv"]
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


def _k2_shapes(cfg, tp: int = 1) -> list:
    """(N, K, launches per layer) of the int8 LM's projections: q, k/v, o,
    gate/up, down; then the speech head (N, K, 0), launched once per step.
    ``tp``: one process's slices under tensor parallelism (``parallel/tp.py``)."""
    from cosyvoice2_eu_torch.parallel.tp import heads_split

    bb = cfg.llm.backbone
    h, q, kv = bb.hidden_size, bb.num_heads * bb.head_dim, bb.num_kv_heads * bb.head_dim
    inter, vocab = bb.intermediate_size, cfg.llm.full_vocab
    if tp > 1:
        a = tp if heads_split(tp, bb.num_heads, bb.num_kv_heads) else 1
        m = tp if inter % tp == 0 else 1
        q, kv, inter = q // a, kv // a, inter // m
        vocab = vocab // tp if vocab % tp == 0 else vocab
    return [(q, h, 1), (kv, h, 2), (h, q, 1), (inter, h, 2), (h, inter, 1), (vocab, h, 0)]


def _with_backbone(bb=None):
    """``TTSConfig()`` with its LM on the backbone ``bb`` (None: the default)."""
    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    return cfg if bb is None else dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, backbone=bb))


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
    weights that start off a 16-byte boundary; in bf16 the edges of the
    wgmma design: M 9 (one past the decode tile), 64 (its 64-row tile), 130
    and 257 (a few rows into the next 128-row tile), 512, at N 128 and 6564
    (a ragged last channel tile) and K 896 and 4864 (1 to 19 K splits); and
    in bf16 and fp32 the edges of the decode design: M 1 to 8 (every row
    tile), N 33, 128 and 6564 (ragged channel groups of 8 and 16), K 16, 64,
    896, 2048, 4864 and 8192 (clusters of 1, 2, 4 and 8 blocks, runs of one
    group to 4096 K, rings of 1 to 4 stages refilled); and at every (N, K)
    of the Qwen3-0.6B backbone's int8 LM (the speech head included), bf16
    and fp32 x at M 1 to 8 (the decode design) and bf16 x at M 9, 64 (its
    bistream extend), 130 and 512 (the wgmma design).
    Each case prints the design it took, which must be the one ``design``
    names: M <= 8 the decode design, bf16 above 8 rows the wgmma one, the
    rest the FMA one.  Every decode case launches twice and the two outputs
    must be bit-equal (no atomics).  Returns the worst error."""
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig, qwen3_0_6b_config
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
    cases += [(n, k, m, both) for n in (33, 128, 6564) for k in (16, 64, 896, 2048, 4864, 8192)
              for m in range(1, i8.DECODE_ROWS + 1)]
    qwen3 = dict.fromkeys((n, k) for n, k, _ in _k2_shapes(_with_backbone(qwen3_0_6b_config())))
    cases += [(n, k, m, both) for n, k in qwen3 for m in range(1, i8.DECODE_ROWS + 1)]
    cases += [(n, k, m, (torch.bfloat16,)) for n, k in qwen3 for m in (9, 64, 130, 512)]
    clusters = {i8.decode_config(m, n, k)[1] for n, k, m, _ in cases if m <= i8.DECODE_ROWS}
    if clusters != {1, 2, 4, 8}:
        raise SystemExit(f"the K2 checks reach clusters {sorted(clusters)}, not 1, 2, 4 and 8")
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
            expect = i8.design(dtype, m, k, x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
            same, again = "", True
            if took == i8.DECODE_SOURCE:  # a second launch: the same bits
                again = torch.equal(_k2_took(x, w_q)[0], got)
                same = f", C={i8.decode_config(m, n, k)[1]}, a second launch bit-equal: {again}"
            ok = (got.shape == (m, n) and math.isfinite(err) and err <= tol and took == expect
                  and again)
            print(f"K2 check M={m} N={n} K={k} x {str(dtype)[6:]}"
                  f"{'' if w_q.data_ptr() % 16 == 0 else ' (weights off 16 B)'} took {took}: "
                  f"max_abs_err={err:.3e} (tol {tol:.3e} = {K2_TOL:g} x max|want|){same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 failed its check at M={m} N={n} K={k} {dtype}: error "
                                 f"{err:.3e} (tol {tol:.3e}), took {took}, expected {expect}"
                                 f"{same}")
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
    fma_bound_ms = max(flops / H100_FP32_FLOPS * 1e3, bytes_ms)  # the same work on FMA units
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, eager_ms=eager_ms,
                bound_ms=bound_ms, fma_bound_ms=fma_bound_ms, ops_ms=ops_ms, bytes_ms=bytes_ms,
                gflop=flops / 1e9, mb=nbytes / 1e6, tflops=flops / ms * 1e-9,
                share=bound_ms / ms)


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


K1_TIMED: dict = {}  # (T, lengths, chunk) -> the bf16 timing of that shape, timed once a run


@_uncounted
def time_flash_attention(shapes: list, launches: int, card: str) -> tuple[dict, list]:
    """K1, its plain version and SDPA at each flow call's shape of a TTS path.

    ``shapes`` holds (T, valid mel frames of each of K1's batch rows, chunk)
    per flow call (the CFG halves double the rows), and each call launches
    K1 equally often; a shape met again, here or on an earlier path, is
    timed once.  Returns the path's
    mean per launch and the kernel's ms at each call's shape.
    """
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for t, lens, chunk in shapes:
        key = (t, tuple(lens), chunk)
        if key in K1_TIMED:  # met on this path or an earlier one
            rows.append(K1_TIMED[key])
            continue
        r = K1_TIMED[key] = _time_k1(lens, t, chunk, torch.bfloat16, False, gen)
        print(f"K1 timing T={t} bf16 chunk={chunk} lengths={lens} [{card}]: kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s on the visible pairs, {100 * r['share']:.1f}% of the "
              f"bound; eager from Python {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['gflop']:.2f} GFLOP, {r['mb']:.2f} MB); output vs plain max_abs_err "
              f"{r['err']:.3e} ok")
        rows.append(r)
    return _weighted([(launches // len(rows), r) for r in rows]), [r["ms"] for r in rows]


def reference_state_dicts(params: dict, weight_norm: str = "parametrizations",
                          hift_prefix: str = "") -> dict:
    """The inverse of ``cosyvoice2_eu_torch/runtime/checkpoint.py``'s
    converters: each of "llm", "flow" and "hift" that ``params`` holds (trees
    of numpy arrays) as the reference's ``llm.pt``, ``flow.pt`` or
    ``hift.pt`` state dict (numpy values).  HiFT's convs are stored under
    weight norm with g = ||v|| over every axis but the first, spelled
    ``parametrizations.weight.original0/1`` as released checkpoints are or,
    with ``weight_norm="weight_g"``, as ``weight_g/weight_v``;
    ``hift_prefix="generator."`` nests them as a GAN-trained checkpoint
    does.  Keys the converters ignore are written too: the LM's tied
    ``lm_head``, the flow's ``rand_noise`` buffer and HiFT's ``stft_window``."""
    out = {}
    if "llm" in params:
        out["llm"] = _reference_llm_state(params["llm"])
    if "flow" in params:
        out["flow"] = _reference_flow_state(params["flow"])
    if "hift" in params:
        out["hift"] = {hift_prefix + k: v
                       for k, v in _reference_hift_state(params["hift"], weight_norm).items()}
    return out


def _linear(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = p["weight"]
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _reference_llm_state(llm: dict) -> dict:
    base, sd = "llm.model.model", {}
    bb = llm["backbone"]
    sd[f"{base}.embed_tokens.weight"] = bb["embed_tokens"]["weight"]
    sd[f"{base}.norm.weight"] = bb["norm"]["weight"]
    sd["llm.model.lm_head.weight"] = bb["embed_tokens"]["weight"]
    for i, layer in enumerate(bb["layers"]):
        pre = f"{base}.layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{pre}.{n}.weight"] = layer[n]["weight"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(sd, f"{pre}.self_attn.{n}", layer[n])
        for n in ("q_norm", "k_norm"):  # qwen3 backbones
            if n in layer:
                sd[f"{pre}.self_attn.{n}.weight"] = layer[n]["weight"]
        for n in ("gate_proj", "up_proj", "down_proj"):
            _linear(sd, f"{pre}.mlp.{n}", layer[n])
    for n in ("llm_embedding", "speech_embedding"):
        sd[f"{n}.weight"] = llm[n]["weight"]
    _linear(sd, "llm_decoder", llm["llm_decoder"])
    return sd


def _reference_flow_state(flow: dict) -> dict:
    sd = {}

    def norm(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["weight"], p["bias"]

    def conformer(pre, p):
        for n in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            _linear(sd, f"{pre}.self_attn.{n}", p["self_attn"][n])
        for n in ("pos_bias_u", "pos_bias_v"):
            sd[f"{pre}.self_attn.{n}"] = p["self_attn"][n]
        _linear(sd, f"{pre}.feed_forward.w_1", p["ffn_w1"])
        _linear(sd, f"{pre}.feed_forward.w_2", p["ffn_w2"])
        norm(f"{pre}.norm_mha", p["norm_mha"])
        norm(f"{pre}.norm_ff", p["norm_ff"])

    def block(pre, p):
        _linear(sd, f"{pre}.block.0", p["conv"])
        norm(f"{pre}.block.2", p["norm"])

    def stage(pre, p, conv: bool):
        block(f"{pre}.0.block1", p["resnet"]["block1"])
        block(f"{pre}.0.block2", p["resnet"]["block2"])
        _linear(sd, f"{pre}.0.mlp.1", p["resnet"]["mlp"])
        _linear(sd, f"{pre}.0.res_conv", p["resnet"]["res_conv"])
        for j, tb in enumerate(p["transformer"]):
            tp = f"{pre}.1.{j}"
            norm(f"{tp}.norm1", tb["norm1"])
            for n in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{tp}.attn1.{n}", tb[n])
            _linear(sd, f"{tp}.attn1.to_out.0", tb["to_out"])
            norm(f"{tp}.norm3", tb["norm3"])
            _linear(sd, f"{tp}.ff.net.0.proj", tb["ff_in"])
            _linear(sd, f"{tp}.ff.net.2", tb["ff_out"])
        if conv:
            _linear(sd, f"{pre}.2", p["conv"])

    sd["input_embedding.weight"] = flow["input_embedding"]["weight"]
    _linear(sd, "spk_embed_affine_layer", flow["spk_embed_affine_layer"])
    _linear(sd, "encoder_proj", flow["encoder_proj"])
    enc = flow["encoder"]
    for e in ("embed", "up_embed"):
        _linear(sd, f"encoder.{e}.out.0", enc[e]["linear"])
        norm(f"encoder.{e}.out.1", enc[e]["norm"])
    _linear(sd, "encoder.pre_lookahead_layer.conv1", enc["pre_lookahead"]["conv1"])
    _linear(sd, "encoder.pre_lookahead_layer.conv2", enc["pre_lookahead"]["conv2"])
    for e in ("encoders", "up_encoders"):
        for i, layer in enumerate(enc[e]):
            conformer(f"encoder.{e}.{i}", layer)
    _linear(sd, "encoder.up_layer.conv", enc["up_layer"])
    norm("encoder.after_norm", enc["after_norm"])
    est, dec = flow["estimator"], "decoder.estimator"
    _linear(sd, f"{dec}.time_mlp.linear_1", est["time_mlp"]["linear_1"])
    _linear(sd, f"{dec}.time_mlp.linear_2", est["time_mlp"]["linear_2"])
    stage(f"{dec}.down_blocks.0", est["down"], True)
    for i, mid in enumerate(est["mid"]):
        stage(f"{dec}.mid_blocks.{i}", mid, False)
    stage(f"{dec}.up_blocks.0", est["up"], True)
    block(f"{dec}.final_block", est["final_block"])
    _linear(sd, f"{dec}.final_proj", est["final_proj"])
    sd["decoder.rand_noise"] = flow["rand_noise"]
    return sd


def _reference_hift_state(hift: dict, weight_norm: str) -> dict:
    import numpy as np

    sd = {}
    names = (("parametrizations.weight.original0", "parametrizations.weight.original1")
             if weight_norm == "parametrizations" else ("weight_g", "weight_v"))

    def wn(prefix, p):
        v = p["weight"]
        sd[f"{prefix}.{names[0]}"] = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)),
                                                    keepdims=True))
        sd[f"{prefix}.{names[1]}"] = v
        if "bias" in p:
            sd[f"{prefix}.bias"] = p["bias"]

    for i, conv in enumerate(hift["f0_predictor"]["convs"]):
        wn(f"f0_predictor.condnet.{2 * i}", conv)
    _linear(sd, "f0_predictor.classifier", hift["f0_predictor"]["classifier"])
    _linear(sd, "m_source.l_linear", hift["m_source"]["l_linear"])
    wn("conv_pre", hift["conv_pre"])
    wn("conv_post", hift["conv_post"])
    for n in ("ups", "source_downs"):
        for i, conv in enumerate(hift[n]):
            wn(f"{n}.{i}", conv)
    for n in ("source_resblocks", "resblocks"):
        for i, rb in enumerate(hift[n]):
            for c in ("convs1", "convs2"):
                for j, conv in enumerate(rb[c]):
                    wn(f"{n}.{i}.{c}.{j}", conv)
            for a, act in (("alpha1", "activations1"), ("alpha2", "activations2")):
                for j, alpha in enumerate(rb[a]):
                    sd[f"{n}.{i}.{act}.{j}.alpha"] = alpha
    n_fft = hift["conv_post"]["weight"].shape[0] - 2  # conv_post: (n_fft + 2, ch, k)
    sd["stft_window"] = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    return sd


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


def _reset_counts() -> None:
    """Set every kernel's launch count to 0 and forget the K1 designs seen."""
    for f in _counters():
        f.launches = 0
    LAUNCHED.clear()


def _k1_design(dtype=None) -> str:
    """The K1 design the path launched since ``LAUNCHED`` was cleared, as
    seen at each launch.  Raises unless every launch was of ``dtype``'s
    design (bf16 by default: the serving paths)."""
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    want = fa.fwd_kernel(dtype or torch.bfloat16)
    if LAUNCHED != {want}:
        raise SystemExit(f"the path launched {sorted(LAUNCHED)}, not only K1's "
                         f"{str(dtype or torch.bfloat16)[6:]} design {want}")
    return f"every launch called {want[0]}, as recorded at each launch"


def main_path(card: str) -> tuple[int, list, list, dict]:
    """Two full-width requests.  Returns K1's launches, each flow call's
    (mel bucket, valid mel frames per K1 row) and flow time in ms, and the
    bf16 LM's parameters."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.ops import flash_attention as fa

    cfg = TTSConfig()
    k1_per_flow = _k1_per_flow(cfg)
    t0 = time.perf_counter()
    model = cosy.load(config=cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: load(TTSConfig(), seed=0, device='cuda') {time.perf_counter() - t0:.2f} s "
          f"[{card}]")
    prompt = _prompt(cfg, 3.0)
    texts = ["Bonjour, comment allez-vous ?", "Il fait beau aujourd'hui."]
    n_prompt = len(prompt["speech_tokens"])
    shapes, flow_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
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
        shapes.append(_k1_shape(cfg, total, False, True))
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
    prefill M took the wgmma design, every decode launch (M <= 8) the decode
    one, and the record holds all ``launches``."""
    from cosyvoice2_eu_torch.ops import int8_matmul as i8

    def expected(m):
        if m in prefill_rows:
            return i8.SM90_SOURCE
        return i8.DECODE_SOURCE if m <= i8.DECODE_ROWS else None

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
    """The int8 LM at full width: one zero-shot request through ``Cosy2EU.tts``,
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
    k1_per_flow = _k1_per_flow(cfg)
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
    # short texts (20 tokens a byte at most): this path's depth is cut to keep the
    # script in its time limit
    texts = [SHORT_TEXT]
    batch_texts = ["Bonjour!", "Hallo Welt", "Guten Tag!", "Merci, Paris"]
    decodes, shapes = [], []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
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
        shapes.append((t_mel, [n * ratio for n in totals] * 2, 0))

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


def _k1_per_flow(cfg) -> int:
    """K1 launches of one flow call: every transformer block of the estimator, each Euler step."""
    est = cfg.flow.estimator
    return (2 + est.num_mid_blocks) * est.n_blocks * cfg.flow.cfm.n_timesteps


def _k1_shape(cfg, total: int, stream: bool, finalize: bool) -> tuple:
    """(T, valid mel frames of each of K1's rows, chunk) of a flow call over
    ``total`` tokens of prompt and generated speech, as ``_token2wav`` makes
    it: a call that is not final feeds the last 3 tokens as context only."""
    from cosyvoice2_eu_torch.runtime.model import FLOW_TOKEN_BUCKETS, bucket_for

    cut = 0 if finalize else cfg.flow.pre_lookahead_len
    t = (bucket_for(total, FLOW_TOKEN_BUCKETS) - cut) * cfg.token_mel_ratio
    chunk = cfg.flow.estimator.static_chunk_size if stream else 0
    return t, [(total - cut) * cfg.token_mel_ratio] * 2, chunk


def _record_flow_calls(tm, calls: list) -> None:
    """Note each flow call of ``tm`` (all go through ``_token2wav``) in
    ``calls``: (prompt + chunk tokens, streaming, finalize, chunk tokens)."""
    import numpy as np

    inner = tm._token2wav

    def recorded(all_tokens, p, token_offset, session, stream, finalize, *args, **kwargs):
        calls.append((len(p.flow_prompt_speech_tokens) + len(all_tokens), stream, finalize,
                      np.asarray(all_tokens).copy()))
        return inner(all_tokens, p, token_offset, session, stream, finalize, *args, **kwargs)

    tm._token2wav = recorded


def _by_path(tree, prefix: str = "") -> dict:
    """{path: leaf} of a dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _by_path(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _by_path(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _record_tokens(tm, out: dict) -> None:
    """Note in ``out["tokens"]`` the generated tokens ``tm``'s non-streaming
    synthesis hands to ``_finalize_full``."""
    import numpy as np

    inner = tm._finalize_full

    def recorded(tokens, *args, **kwargs):
        out["tokens"] = np.asarray(tokens).copy()
        return inner(tokens, *args, **kwargs)

    tm._finalize_full = recorded


def _timed_chunks(chunks, walls: list, lens: list):
    """Yield from the iterable ``chunks``, noting each chunk's wall ms (since
    the previous one, the first since this call) and its samples."""
    t_prev = time.perf_counter()
    for chunk in chunks:
        now = time.perf_counter()
        walls.append((now - t_prev) * 1e3)
        lens.append(int(chunk.size))
        t_prev = now
        yield chunk


def _reset_peak() -> None:
    """Free what earlier requests left (a model whose wrapped methods form a
    reference cycle outlives its last name until the collector runs), then
    reset the card's peak-memory count, so that the next peak is this
    request's own."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _stream_request(model, text: str, prompt, stream: bool, card: str, what: str) -> dict:
    """One request through ``Cosy2EU.stream`` (or ``.tts``) on a fresh model,
    timed chunk by chunk on the host clock, with its checks: tokens x 960
    samples, every chunk finite and not silent, 560 K1 launches per flow
    call and the flow calls the path makes (recompute: one per chunk;
    cached: the first chunk's and the final one; without streaming: one)."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.ops import flash_attention as fa

    tm = model._model
    cfg = tm.cfg
    calls: list = []
    _record_flow_calls(tm, calls)
    before = fa.flash_attention.launches
    _reset_peak()
    tm.timer.reset()
    chunks, walls = [], []
    t0 = time.perf_counter()
    if stream:
        chunks = list(_timed_chunks(model.stream(text, prompt), walls, []))
    else:
        chunks.append(model.tts(text, prompt)[0])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_tok = tm.last_n_tokens
    stages = tm.timer.summary()
    launched = fa.flash_attention.launches - before
    flow_calls = len(chunks) if (stream and not tm.cached_stream) else 2 if stream else 1
    samples = sum(c.shape[1] for c in chunks)
    ok = (all(c.ndim == 2 and c.shape[0] == 1 and c.dtype == np.float32 and c.shape[1] > 0
              and np.isfinite(c).all() and float(np.abs(c).max()) > 1e-3 for c in chunks)
          and samples == n_tok * 960 and len(calls) == flow_calls
          and launched == _k1_per_flow(cfg) * flow_calls)
    lm_s = sum(stages[k]["total_s"] for k in ("lm_decode", "lm_prefill_chunk", "lm_chunk")
               if k in stages)
    audio_s = samples / cfg.sample_rate
    between = sorted(walls[1:-1])  # the steady chunks: after the first, before the final
    steady = f", steady chunk median {between[len(between) // 2]:.1f} ms" if between else ""
    session = ""
    if stream and tm.cached_stream:
        # the card's memory a session takes: what the caching allocator was
        # asked for across ``_init_stream_state`` must be the bytes
        # ``stream_session_bytes`` sizes on the meta device; what it handed
        # out rounds each tensor up (512-byte granules, and a large block
        # left unsplit when at most 1 MiB would remain)
        want = tm.stream_session_bytes()
        stats0, alloc0 = torch.cuda.memory_stats(), torch.cuda.memory_allocated()
        probe = tm._init_stream_state()
        asked = torch.cuda.memory_stats()["requested_bytes.all.current"] \
            - stats0["requested_bytes.all.current"]
        held = torch.cuda.memory_allocated() - alloc0
        n_tensors = len(probe.tensors())
        del probe
        ok = ok and asked == want and want <= held <= want + n_tensors * 2**21
        session = (f"; stream_session_bytes {want}, on the card {asked} bytes requested and "
                   f"{held} allocated over {n_tensors} tensors")
    print(f"{what}: {len(text.encode())} text bytes -> {n_tok} tokens in {tm.last_decode_steps} "
          f"decode steps, {audio_s:.2f} s audio in {len(chunks)} chunks of "
          f"{[c.shape[1] for c in chunks]} samples; flow calls {len(calls)} (expected "
          f"{flow_calls}), K1 launches {launched} (expected {_k1_per_flow(cfg)} x {flow_calls}); "
          f"time to first audio {walls[0]:.1f} ms, chunk wall ms "
          f"[{', '.join(f'{w:.1f}' for w in walls)}]{steady}, "
          f"RTF {wall / audio_s:.3f}, LM {lm_s * 1e3 / max(n_tok, 1):.2f} ms/token, peak memory "
          f"{peak / 2**30:.2f} GiB{session} [{card}] {'ok' if ok else 'FAIL'}")
    print(f"{what} stages (ms total / count): "
          + ", ".join(f"{k} {v['total_s'] * 1e3:.1f}/{v['count']}" for k, v in stages.items()))
    if not ok:
        raise SystemExit(f"{what} failed its checks")
    return {"tokens": calls[-1][3], "shapes": [_k1_shape(cfg, *c[:3]) for c in calls],
            "launches": launched}


# 8 bytes: ~160 tokens, 7 chunks; also the checkpoint and native phases' text
SHORT_TEXT = "Bonjour!"


def stream_path(card: str) -> tuple[list, int, object]:
    """Streaming at the published widths (bf16): one request of
    ``SHORT_TEXT`` through ``Cosy2EU.stream`` on the recompute path
    (``cached_stream=False``) and one on the chunk-cached flow (the
    default), then the same text through ``Cosy2EU.tts``, each on a fresh
    ``load(seed=0)``; all three must give the same tokens.  Returns each
    flow call's K1 shape, the phase's K1 launches and the tokens."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    prompt = _prompt(cfg, 3.0)
    text = SHORT_TEXT
    _reset_counts()
    runs = {}
    for what, stream, cached in (("stream recompute", True, False),
                                 ("stream cached", True, True), ("non-stream", False, True)):
        model = cosy.load(config=cfg, seed=0, device="cuda")
        model._model.cached_stream = cached
        runs[what] = _stream_request(model, text, prompt, stream, card, what)
        del model
        torch.cuda.empty_cache()
    launches = [f.launches for f in _counters()]
    same = {k: bool(np.array_equal(r["tokens"], runs["non-stream"]["tokens"]))
            for k, r in runs.items()}
    print(f"stream phase: the same tokens as the non-stream request: {same}; K1/K3/K4/K2 "
          f"launches {launches} ({_k1_design()}) [{card}]")
    if not all(same.values()):
        raise SystemExit("streaming changed the tokens of one seed")
    if launches[0] != sum(r["launches"] for r in runs.values()) or any(launches[1:]):
        raise SystemExit("stream phase: K1 launches do not match its flow calls, or a "
                         "backward kernel or K2 ran")
    return ([s for r in runs.values() for s in r["shapes"]], launches[0],
            runs["non-stream"]["tokens"])


def _path_launches(what: str, card: str, flow_calls: int) -> int:
    """Read the counts after a path: K1 launched 560 times a flow call, each
    launch of its bf16 design, and no K2, K3 or K4; returns K1's launches."""
    import cosyvoice2_eu_torch.config as config

    launches = [f.launches for f in _counters()]
    want = _k1_per_flow(config.TTSConfig()) * flow_calls
    print(f"{what}: K1/K3/K4/K2 launches {launches} (K1 expected {want} = 560 x {flow_calls} "
          f"flow calls; {_k1_design()}) [{card}]")
    if launches[0] != want or any(launches[1:]):
        raise SystemExit(f"{what}: K1 launches do not match its flow calls, or a backward "
                         "kernel or K2 ran")
    return launches[0]


def checkpoint_path(card: str) -> tuple[list, int]:
    """Loading a reference model dir at the published widths: the seed-0
    model's fp32 parameters written as ``llm.pt``, ``flow.pt`` and
    ``hift.pt`` by ``reference_state_dicts`` (HiFT under weight norm, as
    released checkpoints store it, and the keys the converters ignore) with
    a one-speaker ``spk2info.pt``, then ``load(model_dir=..., device="cuda")``.
    Every LM and flow parameter must equal the in-memory ``load(seed=0)``'s,
    HiFT's within 1e-6 of each leaf's largest value; the store must give
    back the written prompt; the stream phase's text through ``Cosy2EU.tts``
    with the store's prompt must give the in-memory model's tokens and its
    audio within 1e-3.  The directory is deleted.  Returns the two flow
    calls' K1 shapes and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm import init_lm
    from cosyvoice2_eu_torch.utils.params import tree_map

    cfg = TTSConfig()
    prompt = _prompt(cfg, 3.0)
    text = SHORT_TEXT
    gen = torch.Generator(device="cuda")  # the weights load(seed=0) draws
    gen.manual_seed(0)
    params = tree_map(lambda t: t.cpu().numpy(), {
        "llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
        "hift": init_hift(gen, cfg.hift)})
    spk = {"spk0": {"speech_feat": torch.from_numpy(prompt["prompt_feat"][None]),
                    "speech_token": torch.from_numpy(prompt["speech_tokens"][None]),
                    "llm_embedding": torch.from_numpy(prompt["embedding"][None]),
                    "flow_embedding": torch.from_numpy(prompt["embedding"][None])}}
    with tempfile.TemporaryDirectory(prefix="cosy_model_dir_") as model_dir:
        t0 = time.perf_counter()
        for name, sd in reference_state_dicts(params).items():
            torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                       os.path.join(model_dir, f"{name}.pt"))
        torch.save(spk, os.path.join(model_dir, "spk2info.pt"))
        save_s = time.perf_counter() - t0
        nbytes = {f: os.path.getsize(os.path.join(model_dir, f)) for f in sorted(os.listdir(model_dir))}
        del params

        _reset_counts()
        calls, tokens_ref, tokens_got = [], {}, {}
        ref = cosy.load(config=cfg, seed=0, device="cuda")
        _record_flow_calls(ref._model, calls)
        _record_tokens(ref._model, tokens_ref)
        want = ref.tts(text, prompt)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_api = cosy.load(config=cfg, model_dir=model_dir, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got_p, ref_p = (_by_path(m._model.params) for m in (got_api, ref))
        exact = sorted(got_p) == sorted(ref_p) and all(
            got_p[k].dtype == ref_p[k].dtype and torch.equal(got_p[k], ref_p[k])
            for k in ref_p if not k.startswith("/hift/"))
        hift_rel = max(((got_p[k] - ref_p[k]).abs().max()
                        / ref_p[k].abs().max().clamp_min(1e-30)).item()
                       for k in ref_p if k.startswith("/hift/"))
        stored = got_api._frontend.get_spk("spk0")
        store_ok = all(np.array_equal(stored[k], prompt[k])
                       for k in ("prompt_feat", "speech_tokens", "embedding"))
        _record_flow_calls(got_api._model, calls)
        _record_tokens(got_api._model, tokens_got)
        got = got_api.tts(text, stored)[0]
    n_tok = got_api._model.last_n_tokens
    same_tokens = np.array_equal(tokens_ref["tokens"], tokens_got["tokens"])
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    ok = (exact and hift_rel <= 1e-6 and store_ok and same_tokens and err <= 1e-3
          and got.shape == (1, n_tok * 960) and np.isfinite(got).all()
          and not os.path.exists(model_dir))
    print(f"checkpoint: wrote {nbytes} bytes ({sum(nbytes.values())} in all) in {save_s:.2f} s; "
          f"load(model_dir=..., device='cuda') {load_s:.2f} s; LM and flow parameters equal the "
          f"in-memory model's: {exact}; HiFT max relative error {hift_rel:.3e} (tol 1e-6); the "
          f"store gives back the written prompt: {store_ok}; tts of {len(text.encode())} text "
          f"bytes: the same {n_tok} tokens as the in-memory model: {same_tokens}, audio "
          f"max_abs_err={err:.3e} (tol 1e-3); directory deleted [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the checkpoint round trip failed its checks")
    launches = _path_launches("checkpoint", card, len(calls))
    del ref, got_api
    gc.collect()
    torch.cuda.empty_cache()
    return [_k1_shape(cfg, *c[:3]) for c in calls], launches


def long_path(card: str) -> tuple[list, int]:
    """Past the largest flow bucket at the published widths: a 20 s prompt
    (500 tokens) and a 27-byte text (~540 tokens, so prompt + tokens pass
    1024 and the cached session passes ``stream_max_tokens`` = 768, with
    room for a rollover: 500 + a 200-token window + 2 hops fit in 768),
    each request on a
    fresh ``load(seed=0)``: ``Cosy2EU.tts`` under the default
    ``cached_stream=True`` (the fallback through ``StreamSession``, with
    rollover and escalated chunks), ``Cosy2EU.stream`` under the default
    (``_tts_stream_cached``, rolling over), and the recompute path over the
    first request's tokens through ``_wav_from_token_gen(stream=True)`` with
    ``cached_stream=False`` (no third LM decode).  Gates: equal tokens of the
    two decoded requests; tokens x 960 samples on each path, every chunk
    finite and not silent; K1 560 times a recompute flow call; at least one
    rollover and one escalated steady chunk in the fallback, whose waveform
    must join its session's chunks; no K2, K3 or K4.  Returns the flow
    calls' K1 shapes and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.runtime.model import FLOW_TOKEN_BUCKETS, TTSModel

    cfg = TTSConfig()
    prompt = _prompt(cfg, 20.0)
    text = "Bonjour Paris, hallo Welt!!"  # 27 bytes: ~540 tokens
    n_prompt = len(prompt["speech_tokens"])
    _reset_counts()
    runs, shapes, model = {}, [], None
    for what in ("long tts (StreamSession fallback)", "long stream (cached)",
                 "long recompute stream"):
        if what != "long recompute stream":  # the recompute path reuses the cached run's model
            model = tm = None
            gc.collect()
            model = cosy.load(config=cfg, seed=0, device="cuda")
        tm = model._model
        calls: list = []
        _record_flow_calls(tm, calls)
        fetched = {}
        if what == "long stream (cached)":  # the whole generated row, at the last fetch

            def fetch(state, inner=TTSModel._fetch):
                n_avail, finished, toks = inner(state)
                fetched["tokens"] = toks[:n_avail].copy()
                return n_avail, finished, toks

            tm._fetch = fetch
        _reset_peak()
        tm.timer.reset()
        walls, lens, chunks = [], [], []
        t0 = time.perf_counter()
        if what == "long tts (StreamSession fallback)":
            _record_tokens(tm, fetched)
            inner_hift = tm._hift_chunk
            t_prev, parts = [t0], []

            def hift_chunk(*args, **kwargs):  # one call per emitted chunk
                audio = inner_hift(*args, **kwargs)
                now = time.perf_counter()
                walls.append((now - t_prev[0]) * 1e3)
                lens.append(int(audio.size))
                parts.append(audio[None])
                t_prev[0] = now
                return audio

            tm._hift_chunk = hift_chunk
            wav = model.tts(text, prompt)[0]
            # the session's chunks, which the waveform joins
            chunks = parts if np.array_equal(np.concatenate(parts, axis=1), wav) else [wav[:, :0]]
        elif what == "long stream (cached)":
            chunks = list(_timed_chunks(model.stream(text, prompt), walls, lens))
        else:
            tm.cached_stream = False
            inputs = model._frontend.frontend_cross_lingual(text, prompt)
            fetched["tokens"] = runs["long tts (StreamSession fallback)"]["tokens"]
            chunks = [c[None] for c in _timed_chunks(
                tm._wav_from_token_gen(iter(fetched["tokens"]), inputs, True), walls, lens)]
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stages = tm.timer.summary()
        counts = tm.timer.counts
        n_tok = len(fetched["tokens"])
        samples = sum(c.shape[1] for c in chunks)
        audio_s = samples / cfg.sample_rate
        rollovers = counts.get("stream_rollover", 0)
        escalated = {n: counts.get(f"stream_chunk[{n}]", 0) for n in (25, 50, 100)}
        ok = (all(c.ndim == 2 and c.shape[0] == 1 and c.shape[1] > 0 and np.isfinite(c).all()
                  and float(np.abs(c).max()) > 1e-3 for c in chunks)
              and samples == n_tok * 960 and n_prompt + n_tok > FLOW_TOKEN_BUCKETS[-1])
        if what == "long tts (StreamSession fallback)":
            ok = ok and rollovers >= 1 and escalated[50] + escalated[100] >= 1 \
                and counts.get("first_chunk_recompute", 0) == 1
        if what == "long stream (cached)":
            ok = ok and rollovers >= 1
        between = sorted(walls[1:-1])
        steady = (f", time to first audio {walls[0]:.1f} ms, steady chunk median "
                  f"{between[len(between) // 2]:.1f} ms" if what != "long tts (StreamSession "
                  "fallback)" and between else "")
        session = (f"; rollovers {rollovers}; session steady chunks by size {escalated}; "
                   f"session bytes {tm.stream_session_bytes()}" if tm.cached_stream else "")
        print(f"{what}: {len(text.encode())} text bytes -> {n_tok} tokens (+ {n_prompt} prompt "
              f"= {n_tok + n_prompt}, past the largest flow bucket {FLOW_TOKEN_BUCKETS[-1]}), "
              f"{audio_s:.2f} s audio in {len(chunks)} chunks; wall {wall:.2f} s, RTF "
              f"{wall / audio_s:.3f}{steady}; recompute flow calls {len(calls)}{session}; peak "
              f"memory {peak / 2**30:.2f} GiB [{card}] {'ok' if ok else 'FAIL'}")
        print(f"{what} chunks (wall ms, samples): "
              + ", ".join(f"{w:.1f}/{n}" for w, n in zip(walls, lens)))
        print(f"{what} stages (ms total / count): "
              + ", ".join(f"{k} {v['total_s'] * 1e3:.1f}/{v['count']}" for k, v in stages.items()))
        if not ok:
            raise SystemExit(f"{what} failed its checks")
        runs[what] = {"tokens": fetched["tokens"], "calls": len(calls)}
        shapes += [_k1_shape(cfg, *c[:3]) for c in calls]
    del model, tm
    gc.collect()
    torch.cuda.empty_cache()
    same = np.array_equal(runs["long tts (StreamSession fallback)"]["tokens"],
                          runs["long stream (cached)"]["tokens"])
    print(f"long phase: the fallback and the cached stream decode the same tokens: {same} "
          f"[{card}]")
    if not same:
        raise SystemExit("the long requests of one seed decoded different tokens")
    return shapes, _path_launches("long phase", card, sum(r["calls"] for r in runs.values()))


def vc_path(card: str, source) -> tuple[list, int]:
    """``TTSModel.vc`` at the published widths on a fresh ``load(seed=0)``:
    the stream phase's tokens as the source, the 3 s prompt, without and
    with streaming.  Gates: tokens x 960 samples each, every chunk finite
    and not silent, K1 560 times a flow call (one, or one a chunk).
    Returns the flow calls' K1 shapes and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    model = cosy.load(config=cfg, seed=0, device="cuda")
    tm = model._model
    inputs = model._frontend.frontend_cross_lingual("", _prompt(cfg, 3.0))
    _reset_counts()
    calls, n_calls = [], 0
    _record_flow_calls(tm, calls)
    for stream in (False, True):
        tm.timer.reset()
        before = len(calls)
        walls, lens = [], []
        t0 = time.perf_counter()
        chunks = list(_timed_chunks(tm.vc(source, inputs, stream=stream), walls, lens))
        wall = time.perf_counter() - t0
        samples = sum(lens)
        flows = len(calls) - before
        ok = (all(c.size > 0 and np.isfinite(c).all() and float(np.abs(c).max()) > 1e-3
                  for c in chunks) and samples == len(source) * 960
              and flows == (len(chunks) if stream else 1))
        audio_s = samples / cfg.sample_rate
        print(f"vc (stream={stream}): {len(source)} source tokens -> {audio_s:.2f} s audio in "
              f"{len(chunks)} chunks; flow calls {flows}; wall {wall:.2f} s, RTF "
              f"{wall / audio_s:.3f}, first chunk {walls[0]:.1f} ms; chunks (wall ms, samples) "
              + ", ".join(f"{w:.1f}/{n}" for w, n in zip(walls, lens)) + f" [{card}] "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"vc (stream={stream}) failed its checks")
        n_calls += flows
    launches = _path_launches("vc phase", card, n_calls)
    del model, tm
    gc.collect()
    torch.cuda.empty_cache()
    return [_k1_shape(cfg, *c[:3]) for c in calls], launches


# card vs CPU tolerances of the frontend phase (full widths, fp32, TF32 off)
FEAT_REL_TOL = 1e-5  # the 24 kHz prompt mel, compared linearly, relative to its peak
WHISPER_TOL = 1e-3  # the whisper log-mel ((log10 + 4) / 4; bins 8 decades down are clamped)
Z_TOL = 1e-3  # the tokenizer's z before the FSQ head
FSQ_EPS = Z_TOL  # a code may differ only where a digit's pre-rounding value lies within
#                  FSQ_EPS of +-0.5 (|d tanh(z) * 0.999 / dz| <= 1, so z_err bounds the move)
EMB_REL_TOL = 1e-4  # the CAM++ x-vector, relative to its largest value


def write_prompt_wavs(directory: str) -> dict:
    """16-bit PCM prompts from a seeded signal (a harmonic glide plus noise):
    16 kHz mono of 3 s and 30 s (the limit: 3000 whisper frames, 750
    codes) and 48 kHz stereo of 3 s (``load_wav``'s channel mean and
    resampling).  Returns {name: (path, seconds)}."""
    import wave

    import numpy as np

    out = {}
    for name, seconds, sr, channels in (("3s", 3.0, 16000, 1), ("30s", 30.0, 16000, 1),
                                        ("3s_48k_stereo", 3.0, 48000, 2)):
        rng = np.random.default_rng(len(out))
        t = np.arange(int(seconds * sr)) / sr
        f0 = 120.0 + 80.0 * (t / seconds)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        sig = sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3, 4))
        sig = np.stack([sig * (1.0 - 0.2 * c) for c in range(channels)], axis=1)
        sig = np.clip(sig + 0.01 * rng.standard_normal(sig.shape), -1, 1)
        path = os.path.join(directory, f"prompt_{name}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((sig * 32767).astype(np.int16).tobytes())
        out[name] = (path, seconds)
    return out


def _perturbed_norms(tree, gen):
    """CAM++'s BatchNorm statistics drawn from ``gen`` away from init's
    (mean 0, var 1, weight 1, bias 0), so the card's norms do real work."""
    import torch

    if isinstance(tree, dict):
        if set(tree) == {"weight", "bias", "mean", "var"}:
            c, dev = tree["weight"].shape, tree["weight"].device
            return {"weight": 0.5 + torch.rand(c, generator=gen, device=dev),
                    "bias": 0.2 * torch.randn(c, generator=gen, device=dev),
                    "mean": 0.3 * torch.randn(c, generator=gen, device=dev),
                    "var": 0.3 + 1.5 * torch.rand(c, generator=gen, device=dev)}
        return {k: _perturbed_norms(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed_norms(v, gen) for v in tree]
    return tree


def _check_frontend_on_card(st_params, cam_params, wav, card: str) -> None:
    """The 3 s prompt through the frontend's stages on the card and on the
    CPU (parameters copied there), each held to its tolerance: the prompt
    mel, the whisper log-mel, z, the codes (a differing code only where its
    digit lies within ``FSQ_EPS`` of a rounding boundary) and the x-vector."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.frontend import frontend as fe_mod
    from cosyvoice2_eu_torch.models import campplus as cam
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.ops.mel import whisper_log_mel
    from cosyvoice2_eu_torch.utils.params import tree_map

    cfg, st_cfg, cam_cfg = TTSConfig(), st.SpeechTokenizerConfig(), cam.CAMPPlusConfig()
    out = {}
    for dev, sp, cp in (("cuda", st_params, cam_params),
                        ("cpu", tree_map(lambda t: t.cpu(), st_params),
                         tree_map(lambda t: t.cpu(), cam_params))):
        fe = fe_mod.Frontend(cfg, device=dev)
        with torch.inference_mode():
            mel = whisper_log_mel(torch.tensor(wav, device=dev)[None], n_mels=st_cfg.n_mels)
            t = mel.shape[-1] - mel.shape[-1] % st_cfg.downsample
            z, _, _ = st.encode_z(sp, st_cfg, mel[:, :, :t], torch.tensor([t], device=dev))
            emb = cam.campplus_forward(cp, cam_cfg, cam.kaldi_fbank_cmn(
                torch.tensor(wav, device=dev)[None], cam_cfg.feat_dim))
        out[dev] = {"feat": fe.mel_fn(fe_mod.resample(wav, 16000, 24000)),
                    "mel": mel.cpu().numpy(), "z": z.float().cpu(), "emb": emb.cpu().numpy()}
    g, c = out["cuda"], out["cpu"]
    lin_g, lin_c = np.exp(g["feat"].astype(np.float64)), np.exp(c["feat"].astype(np.float64))
    feat_rel = float(np.abs(lin_g - lin_c).max() / lin_c.max())
    feat_log = float(np.abs(g["feat"] - c["feat"]).max())
    whisper_err = float(np.abs(g["mel"] - c["mel"]).max())
    z_err = float((g["z"] - c["z"]).abs().max())
    codes_g, codes_c = (st.fsq_quantize(x["z"], st_cfg.fsq_levels)[0] for x in (g, c))
    bounded = torch.tanh(c["z"]) * st.FSQ_TANH_SCALE  # levels 3: half = 1
    digits_differ = torch.round(torch.tanh(g["z"]) * st.FSQ_TANH_SCALE) != torch.round(bounded)
    margins = ((bounded.abs() - 0.5).abs())[digits_differ]
    n_codes = int((codes_g != codes_c).sum())
    worst_margin = float(margins.max()) if n_codes else 0.0
    emb_rel = float(np.abs(g["emb"] - c["emb"]).max() / np.abs(c["emb"]).max())
    ok = (feat_rel <= FEAT_REL_TOL and whisper_err <= WHISPER_TOL and z_err <= Z_TOL
          and worst_margin < FSQ_EPS and emb_rel <= EMB_REL_TOL
          and codes_g.shape == codes_c.shape == (1, 75))
    print(f"frontend card vs CPU, 3 s prompt, published widths: prompt_feat relative error "
          f"{feat_rel:.3e} (linear, tol {FEAT_REL_TOL:g}; log-domain max_abs_err {feat_log:.3e}), "
          f"whisper log-mel max_abs_err {whisper_err:.3e} (tol {WHISPER_TOL:g}), z max_abs_err "
          f"{z_err:.3e} (tol {Z_TOL:g}), codes differing {n_codes} of {codes_c.numel()} (largest "
          f"margin among their digits {worst_margin:.3e}, must be < {FSQ_EPS:g}), embedding "
          f"relative error {emb_rel:.3e} (tol {EMB_REL_TOL:g}) [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the frontend on the card disagrees with the CPU")


def _time_extraction(fe, path: str, seconds: float, card: str, runs: int = 6) -> dict:
    """``load_wav`` + ``extract_prompt`` of one prompt ``runs`` times, each
    stage synchronised: the first call and the median of the warm ones."""
    import numpy as np

    from cosyvoice2_eu_torch.frontend.frontend import load_wav

    names = {"load_wav": "load_wav+resample", "prompt_mel": "mel_fn",
             "prompt_speech_tokens": "whisper+encode", "prompt_embedding": "fbank+CAM++"}
    times = []
    for _ in range(runs):
        fe.timer.reset()
        t0 = time.perf_counter()
        wav = load_wav(path, 16000)
        load_s = time.perf_counter() - t0
        art = fe.extract_prompt(wav)
        stages = {"load_wav": load_s, **{k: v["total_s"] for k, v in fe.timer.summary().items()}}
        times.append({k: stages[k] * 1e3 for k in names})
    n_tok = int(seconds * fe.cfg.flow.input_frame_rate)
    ok = (len(art["speech_tokens"]) == n_tok
          and art["prompt_feat"].shape == (2 * n_tok, fe.cfg.mel.num_mels)
          and np.isfinite(art["prompt_feat"]).all() and np.isfinite(art["embedding"]).all()
          and art["speech_tokens"].min() >= 0 and art["speech_tokens"].max() < 6561)
    warm = {k: float(np.median([t[k] for t in times[1:]])) for k in names}
    fmt = lambda d: ", ".join(f"{names[k]} {d[k]:.2f}" for k in names)  # noqa: E731
    print(f"extract_prompt {os.path.basename(path)} ({seconds:g} s, {n_tok} codes, "
          f"{2 * n_tok} mel frames): first call ms {fmt(times[0])}, total "
          f"{sum(times[0].values()):.2f}; warm median of {runs - 1} ms {fmt(warm)}, total "
          f"{sum(warm.values()):.2f}; warm ms per prompt second "
          f"{sum(warm.values()) / seconds:.2f} [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"extract_prompt of {path} failed its checks")
    return {"first": times[0], "warm": warm}


def frontend_path(card: str) -> tuple[list, int]:
    """The prompt frontend at the published widths on the card: the FSQ
    speech tokenizer (123,476,488 parameters) and CAM++ (6,931,104, its
    norms perturbed) drawn from a seeded ``torch.Generator``, checked
    against the CPU (``_check_frontend_on_card``), ``extract_prompt`` timed
    per stage at 3 s, 30 s and a 48 kHz stereo 3 s wav, then the user's
    call: a fresh ``load(seed=0, download=False)`` wrapped in
    ``Cosy2EU(model, frontend, cfg)``, a zero-shot ``tts`` on the 3 s wav
    with ``text_frontend=True`` (a number spelled out) and an instruct2
    ``stream`` on the same wav, which must hit the prompt cache.  Gates:
    tokens x 960 samples, finite non-silent audio, K1 560 times a flow call.
    Returns the flow calls' K1 shapes and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.frontend import frontend as fe_mod
    from cosyvoice2_eu_torch.models import campplus as cam
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    st_cfg, cam_cfg = st.SpeechTokenizerConfig(), cam.CAMPPlusConfig()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    st_params = st.init_speech_tokenizer(gen, st_cfg)
    cam_params = _perturbed_norms(cam.init_campplus(gen, cam_cfg), gen)
    n_st, n_cam = (sum(t.numel() for t in tree_leaves(p)) for p in (st_params, cam_params))
    print(f"frontend: speech tokenizer {n_st:,} parameters, CAM++ {n_cam:,}, fp32 on the card")
    if (n_st, n_cam) != (123_476_488, 6_931_104):
        raise SystemExit("the frontend models are not at the published widths")
    model = cosy.load(seed=0, download=False, device="cuda")
    cfg = model._cfg
    fe = fe_mod.Frontend(cfg, tokenizer=model._frontend.tokenizer,
                         speech_tokenizer_fn=fe_mod.make_speech_tokenizer_fn(
                             st_params, st_cfg, device="cuda"),
                         spk_embedding_fn=fe_mod.make_spk_embedding_fn(
                             cam_params, cam_cfg, device="cuda"),
                         device="cuda")
    api = cosy.Cosy2EU(model._model, fe, cfg)
    tm = model._model
    with tempfile.TemporaryDirectory(prefix="cosy_prompts_") as d:
        wavs = write_prompt_wavs(d)
        _check_frontend_on_card(st_params, cam_params, fe_mod.load_wav(wavs["3s"][0], 16000),
                                card)
        for name in ("3s", "30s", "3s_48k_stereo"):
            _time_extraction(fe, *wavs[name], card)
        prompt_text = "Bonjour, je m'appelle Claire."
        requests = (("zero_shot tts", "3 chats.", False,
                     dict(mode="zero_shot", text_frontend=True)),
                    ("instruct2 stream", "Bonjour !", True,
                     dict(mode="instruct2", instruct_text="Parle lentement.",
                          text_frontend=True)))
        _reset_counts()
        calls: list = []
        _record_flow_calls(tm, calls)
        for i, (what, text, stream, kw) in enumerate(requests):
            segments = fe.normalize_text(text)
            fe.timer.reset()
            tm.timer.reset()
            _reset_peak()
            before = (len(calls), _counters()[0].launches)
            walls, lens = [], []
            t0 = time.perf_counter()
            if stream:
                chunks = list(_timed_chunks(api.stream(text, wavs["3s"][0],
                                                       prompt_text=prompt_text, **kw),
                                            walls, lens))
            else:
                chunks = [api.tts(text, wavs["3s"][0], prompt_text=prompt_text, **kw)[0]]
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            n_tok, samples = tm.last_n_tokens, sum(c.shape[1] for c in chunks)
            flows = len(calls) - before[0]
            launched = _counters()[0].launches - before[1]
            front = {k: v["total_s"] for k, v in fe.timer.summary().items()}
            stages = {k: v["total_s"] for k, v in tm.timer.summary().items()}
            audio_s = samples / cfg.sample_rate
            cached = i > 0
            ok = (samples == n_tok * 960 and all(np.isfinite(c).all() for c in chunks)
                  and max(float(np.abs(c).max()) for c in chunks) > 1e-3
                  and launched == _k1_per_flow(cfg) * flows and flows >= 1
                  and len(api._prompt_cache) == 1 and (not front if cached else
                                                        {"prompt_load_wav", "prompt_mel",
                                                         "prompt_speech_tokens",
                                                         "prompt_embedding"} <= set(front)))
            print(f"{what}: {len(text.encode())} text bytes normalised to {segments} -> {n_tok} "
                  f"tokens, {audio_s:.2f} s audio in {len(chunks)} chunks; prompt cache "
                  f"{'hit (no extraction)' if cached else 'miss (extracted)'}; wall "
                  f"{wall:.2f} s, RTF {wall / audio_s:.3f}, time to first audio {walls[0]:.1f} ms; "
                  f"stage ms: " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in {**front,
                                                                              **stages}.items())
                  + f"; frontend share {100 * sum(front.values()) / wall:.1f}%; peak memory "
                  f"{peak / 2**30:.2f} GiB; flow calls {flows}, K1 launches {launched} (expected "
                  f"{_k1_per_flow(cfg)} x {flows}) [{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the frontend phase's {what} failed its checks")
    launches = _path_launches("frontend phase", card, len(calls))
    del model, api, tm, fe, st_params, cam_params
    gc.collect()
    torch.cuda.empty_cache()
    return [_k1_shape(cfg, *c[:3]) for c in calls], launches


def int8_stream_path(card: str) -> tuple[list, int, tuple, int]:
    """One shorter request through ``Cosy2EU.stream`` on the chunk-cached
    flow with ``lm_quant="int8"``: K2 launched 168 + 169 x decode steps
    times over the chunked decode, each prefill launch on the wgmma design
    and each decode launch on the decode one.  Returns its flow calls' K1
    shapes, K1's launches, its LM decode's (batch, prompt bucket, steps)
    and K2's launches."""
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    n_layers = cfg.llm.backbone.num_layers
    model = cosy.load(config=cfg, seed=0, device="cuda", lm_quant="int8")
    tm = model._model
    prompt = _prompt(cfg, 3.0)
    text = "Bonjour!"
    _reset_counts()
    K2_LAUNCHED.clear()
    run = _stream_request(model, text, prompt, True, card, "int8 stream cached")
    launches = [f.launches for f in _counters()]
    steps = tm.last_decode_steps
    p_bucket = tm._pack_lm_prompt(model._frontend.frontend_cross_lingual(text, prompt))[3]
    want = 7 * n_layers + (7 * n_layers + 1) * steps
    designs = _k2_designs({p_bucket}, launches[3])
    print(f"int8 stream: K2 launches {launches[3]} (expected {7 * n_layers} + "
          f"{7 * n_layers + 1} x {steps} steps = {want}; by M, as recorded at each launch: "
          f"{designs}); K1 {_k1_design()} [{card}]")
    if launches[3] != want or launches[1:3] != [0, 0] or launches[0] != run["launches"]:
        raise SystemExit("int8 stream: K2 launches do not match its decode steps, or a "
                         "backward kernel ran")
    del model, tm
    torch.cuda.empty_cache()
    return run["shapes"], launches[0], (1, p_bucket, steps), launches[3]


# Tolerance of the chunk-cached mel against the full-prefix recompute on the
# card (small config, fp32).  The two differ only where the recompute
# attends through K1's 3xTF32 products and the cached flow through fp32
# einsums.  On an H100 (80GB HBM3, 700 W) these seeds read 1.281e-6,
# 1.401e-6, 1.311e-6, 1.483e-6 and 1.073e-6; the tolerance is ~10x the
# largest.
STREAM_MEL_SEEDS = (4, 5, 6, 7, 8)
STREAM_MEL_TOL = 1.5e-5


def _small_stream_setup() -> tuple:
    """The small config of the card-vs-CPU streaming checks (K1 takes the
    estimator's 64-wide heads), its weights from a seed, and
    ``hift_draws(device)``: a fresh sequence of per-call HiFT draws, the
    same on every device."""
    import torch

    from cosyvoice2_eu_torch.config import tiny_test_config
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm import init_lm

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, flow=dataclasses.replace(
        cfg.flow, estimator=dataclasses.replace(cfg.flow.estimator, attention_head_dim=64,
                                                num_heads=2)))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    params = {"llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
              "hift": init_hift(gen, cfg.hift)}

    def hift_draws(dev):
        g = torch.Generator(device="cpu")
        g.manual_seed(3)
        return lambda b, length, h: (torch.rand((b, h), generator=g).to(dev),
                                     torch.randn((b, length, h), generator=g).to(dev))

    return cfg, params, hift_draws


@_uncounted
def check_small_stream() -> None:
    """Streaming on the card against the plain CPU path on a small config
    (fp32, the same weights and injected draws, as ``check_small_reference``):
    the chunk-cached path, the recompute path and a cached stream past a
    100-token cap (rollover); equal chunk counts and lengths, audio within
    1e-3.  Then, on the card, the cached flow's mel against the recompute
    (K1 at chunk 50) for each of ``STREAM_MEL_SEEDS``, within
    ``STREAM_MEL_TOL``."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.models import flow_streaming as fs
    from cosyvoice2_eu_torch.models.flow import flow_inference
    from cosyvoice2_eu_torch.ops.sampling import gumbel
    from cosyvoice2_eu_torch.runtime.model import TTSModel
    from cosyvoice2_eu_torch.utils.params import tree_map

    cfg, params, hift_draws = _small_stream_setup()
    g_lm = torch.Generator(device="cpu")
    g_lm.manual_seed(2)
    lm_noise = [(gumbel((1, cfg.llm.top_k), g_lm), gumbel((1, cfg.llm.full_vocab), g_lm))
                for _ in range(256)]

    # 60 bytes: min_len 120 tokens, past the rollover case's 100-token cap
    text = "Bonjour tout le monde, il fait beau aujourd'hui a Paris. Oui"
    prompt = Frontend(cfg).frontend_zero_shot(text, _prompt(cfg, 0.24, 4))
    for what, kw in (("cached", {}), ("recompute", {"cached_stream": False}),
                     ("rollover", {"stream_max_tokens": 100, "stream_rollover_window": 25})):
        out = {}
        for dev in ("cpu", "cuda"):
            tm = TTSModel(cfg, params, seed=0, compute_dtype=None, device=dev, **kw)
            chunks = list(tm.tts(prompt, stream=True, hift_draws=hift_draws(dev),
                                 lm_draws=lambda step: tuple(x.to(dev) for x in lm_noise[step])))
            out[dev] = (chunks, tm.last_n_tokens, tm.timer.counts.get("stream_rollover", 0))
        (c_cpu, n_cpu, r_cpu), (c_gpu, n_gpu, r_gpu) = out["cpu"], out["cuda"]
        lens = [len(c) for c in c_gpu]
        same = lens == [len(c) for c in c_cpu] and n_cpu == n_gpu
        err = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(c_gpu, c_cpu)) \
            if same else float("inf")
        ok = (same and err <= 1e-3 and all(np.isfinite(c).all() for c in c_gpu)
              and sum(lens) == n_gpu * 960 and (what != "rollover" or r_gpu == r_cpu >= 1))
        print(f"stream reference check (small config, fp32, {what}, card vs CPU plain path): "
              f"{n_gpu} vs {n_cpu} tokens, {len(c_gpu)} vs {len(c_cpu)} chunks of {lens} samples, "
              f"rollovers {r_gpu} vs {r_cpu}, audio max_abs_err={err:.3e} (tol 1e-3) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the card's {what} stream disagrees with the plain CPU path")

    # cached mel against the full-prefix recompute, on the card, for a few seeds
    flow = tree_map(lambda x: x.to("cuda"), params["flow"])
    sparams = fs.prepare_stream_params(flow, cfg.flow, 128)
    hop, la = cfg.flow.encoder.static_chunk_size, cfg.flow.pre_lookahead_len
    errs = []
    for seed in STREAM_MEL_SEEDS:
        state = fs.init_flow_stream_state(cfg.flow, 128, dtype=torch.float32, device="cuda")
        rng = np.random.default_rng(seed)
        tokens = torch.as_tensor(rng.integers(0, cfg.flow.vocab_size, (1, 3 * hop + la)),
                                 device="cuda")
        xvec = torch.as_tensor(rng.standard_normal((1, cfg.flow.spk_embed_dim)), device="cuda",
                               dtype=torch.float32)
        worst = 0.0
        for c in range(3):
            o = c * hop
            got, state = fs.flow_chunk(sparams, cfg.flow, state, tokens[:, o:o + hop],
                                       tokens[:, o + hop:o + hop + la], xvec,
                                       torch.zeros((1, 2 * hop, cfg.flow.output_size),
                                                   device="cuda"))
            upto = o + hop + la
            mel = flow_inference(flow, cfg.flow, tokens[:, :upto],
                                 torch.tensor([upto], device="cuda"),
                                 torch.zeros((1, 8, cfg.flow.output_size), device="cuda"),
                                 torch.tensor([0], device="cuda"), xvec, streaming=True,
                                 finalize=False)
            worst = max(worst, (got - mel[:, :, 2 * o:2 * (o + hop)]).abs().max().item())
        errs.append(worst)
    ok = all(math.isfinite(e) and e <= STREAM_MEL_TOL for e in errs)
    print(f"stream mel check (small config, fp32, on the card): 3 chunk-cached flow chunks "
          f"against the full-prefix recompute (K1 at chunk 50), seeds {list(STREAM_MEL_SEEDS)}: "
          f"max_abs_err {', '.join(f'{e:.3e}' for e in errs)} (tol {STREAM_MEL_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the chunk-cached flow disagrees with the recompute on the card")


@_uncounted
def check_small_session() -> None:
    """The serving path's ``StreamSession`` and ``vc`` on the card against
    the plain CPU path, small config, fp32, the same weights and injected
    HiFT draws, with the largest flow bucket cut to 128 tokens: 400 tokens
    through ``_finalize_full`` past that bucket under a 256-token cached
    window (first emission, steady chunks escalating to 50 and 100 tokens,
    a rollover, the windowed finalize), then 150 tokens through a session
    whose 48-token cap the first feed does not fit (the finalize drains
    them in recompute chunks), then ``vc`` of 80 tokens with and without
    streaming.  Equal chunk counts and lengths (for ``_finalize_full``:
    equal stage counts, one HiFT call a chunk, and equal length), audio
    within 1e-3."""
    import numpy as np

    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.runtime import model as rt
    from cosyvoice2_eu_torch.serving.engine import StreamSession

    cfg, params, hift_draws = _small_stream_setup()
    prompt = Frontend(cfg).frontend_zero_shot("Bonjour.", _prompt(cfg, 0.24, 4))
    rng = np.random.default_rng(9)
    long_tokens, cap_tokens, source = (rng.integers(0, cfg.flow.vocab_size, n).astype(np.int32)
                                       for n in (400, 150, 80))
    stages = ("first_chunk_recompute", "stream_rollover", "stream_chunk[25]",
              "stream_chunk[50]", "stream_chunk[100]", "flow", "hift")
    cases = {
        "finalize_full past the bucket": (
            {"stream_max_tokens": 256, "stream_rollover_window": 50},
            lambda tm, d: [tm._finalize_full(long_tokens, prompt, {"hift_cache": None},
                                             hift_draws=d)]),
        "session drained at the cap": (
            {"stream_max_tokens": 48},
            lambda tm, d: StreamSession(tm, prompt, hift_draws=d).feed(cap_tokens, True)),
        "vc": ({}, lambda tm, d: list(tm.vc(source, prompt, hift_draws=d))),
        "vc stream": ({}, lambda tm, d: list(tm.vc(source, prompt, stream=True, hift_draws=d))),
    }
    saved = rt.FLOW_TOKEN_BUCKETS
    rt.FLOW_TOKEN_BUCKETS = (64, 128)
    try:
        for what, (kw, run) in cases.items():
            out = {}
            for dev in ("cpu", "cuda"):
                tm = rt.TTSModel(cfg, params, seed=0, compute_dtype=None, device=dev, **kw)
                chunks = run(tm, hift_draws(dev))
                out[dev] = (chunks, [tm.timer.counts.get(k, 0) for k in stages])
            (c_cpu, s_cpu), (c_gpu, s_gpu) = out["cpu"], out["cuda"]
            lens = [len(c) for c in c_gpu]
            same = lens == [len(c) for c in c_cpu] and s_gpu == s_cpu
            err = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(c_gpu, c_cpu)) \
                if same else float("inf")
            n_tok = {"vc": 80, "vc stream": 80, "session drained at the cap": 150}.get(what, 400)
            counts = dict(zip(stages, s_gpu))
            happened = {
                "finalize_full past the bucket": counts["first_chunk_recompute"] == 1
                and counts["stream_rollover"] >= 1 and counts["stream_chunk[50]"] >= 1
                and counts["stream_chunk[100]"] >= 1,
                "session drained at the cap": counts["first_chunk_recompute"] == 0
                and counts["flow"] == len(lens) >= 3,
                "vc": counts["flow"] == len(lens) == 1,
                "vc stream": counts["flow"] == len(lens) == 4,
            }[what]
            ok = (same and happened and err <= 1e-3 and sum(lens) == n_tok * 960
                  and all(np.isfinite(c).all() for c in c_gpu))
            print(f"session reference check (small config, fp32, {what}, card vs CPU plain "
                  f"path): {len(c_gpu)} vs {len(c_cpu)} chunks of {lens} samples, stage counts "
                  f"{counts} (CPU {dict(zip(stages, s_cpu))}), audio max_abs_err={err:.3e} "
                  f"(tol 1e-3) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the card's {what} disagrees with the plain CPU path")
    finally:
        rt.FLOW_TOKEN_BUCKETS = saved


def _fed_state(tm, n_chunks: int, rng):
    """A flow state of ``tm`` fed ``n_chunks`` hops of seeded random tokens
    (its cursor at n_chunks x 25 tokens)."""
    import numpy as np

    cfg = tm.cfg
    hop, la = tm.token_hop_len, tm.pre_lookahead_len
    st = tm._init_stream_state()
    tokens = rng.integers(0, cfg.flow.vocab_size, n_chunks * hop + la).astype(np.int32)
    xvec = rng.standard_normal(cfg.flow.spk_embed_dim).astype(np.float32)
    cond = np.zeros((2 * hop, cfg.flow.output_size), np.float32)
    for c in range(n_chunks):
        o = c * hop
        _, st = tm._flow_feed(st, tokens[o:o + hop], tokens[o + hop:o + hop + la], cond, xvec)
    return st


@_uncounted
def check_small_engine() -> None:
    """The engine's batched steps on the card against the plain CPU path,
    small config, fp32, the same weights and draws: ``slots_decode`` on 4
    slots (two prompts in slots 0 and 2, slot 1 empty, slot 3 ending at a
    ``max_len`` of 10), two calls of 16 steps, must give equal tokens,
    lengths and ``finished`` after each; ``_stream_chunk_batch`` over two
    sessions at cursors 50 and 75, padded to 4 rows with the empty state,
    audio and the rotated caches within 1e-3, cursors equal."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.ops.sampling import gumbel
    from cosyvoice2_eu_torch.runtime.model import TTSModel

    cfg, params, hift_draws = _small_stream_setup()
    g = torch.Generator(device="cpu")
    g.manual_seed(6)
    noise = [(gumbel((4, cfg.llm.top_k), g), gumbel((4, cfg.llm.full_vocab), g))
             for _ in range(32)]
    fe = Frontend(cfg)
    prompts = [fe.frontend_zero_shot(text, _prompt(cfg, 0.24, seed))
               for seed, text in ((4, "Bonjour tout le monde."), (5, "Guten Tag."))]
    out = {}
    for dev in ("cpu", "cuda"):
        tm = TTSModel(cfg, params, seed=0, compute_dtype=None, device=dev, stream_max_tokens=128)
        llm = tm.params["llm"]
        st = llm_mod.slots_init(cfg.llm, 4, 256, 128, dtype=torch.float32, device=tm.device)
        for slot, p, cap in ((0, prompts[0], None), (2, prompts[1], None), (3, prompts[1], 10)):
            ids, src, prompt_len, _, min_len, max_len = tm._pack_lm_prompt(p)
            st = llm_mod.slot_prefill(llm, cfg.llm, st, slot, tm._tensor(ids), tm._tensor(src),
                                      prompt_len, min_len, cap or max_len)
        decoded = []
        for _ in range(2):
            st = llm_mod.slots_decode(llm, cfg.llm, st, 16,
                                      lambda s: tuple(x.to(tm.device) for x in noise[s]))
            decoded.append([x.cpu().numpy() for x in (st.tokens, st.lengths, st.finished)])
        rng = np.random.default_rng(7)
        states = [_fed_state(tm, n, rng) for n in (2, 3)] + [tm._init_stream_state()] * 2
        mc, sc, hop, la = tm.mel_cache_len, tm.source_cache_len, tm.token_hop_len, \
            tm.pre_lookahead_len
        tok = rng.integers(0, cfg.flow.vocab_size, (4, hop)).astype(np.int32)
        ctx = rng.integers(0, cfg.flow.vocab_size, (4, la)).astype(np.int32)
        emb = rng.standard_normal((4, cfg.flow.spk_embed_dim)).astype(np.float32)
        cond = np.zeros((4, 2 * hop, cfg.flow.output_size), np.float32)
        c_mel = rng.standard_normal((4, cfg.flow.output_size, mc)).astype(np.float32)
        c_src = (0.1 * rng.standard_normal((4, 1, sc))).astype(np.float32)
        c_sp = (0.1 * rng.standard_normal((4, sc))).astype(np.float32)
        tok[2:], ctx[2:], emb[2:] = tok[0], ctx[0], emb[0]
        c_mel[2:], c_src[2:], c_sp[2:] = 0.0, 0.0, 0.0
        new, audio, mel2, src2, sp2 = tm._stream_chunk_batch(
            hop, states, tok, ctx, emb, cond, tm._tensor(c_mel, torch.float32),
            tm._tensor(c_src, torch.float32), c_sp, hift_draws=hift_draws(tm.device))
        out[dev] = (decoded, [s.t_tok for s in new], audio,
                    [mel2.cpu().numpy(), src2.cpu().numpy(), sp2])
    (d_cpu, t_cpu, a_cpu, c_cpu), (d_gpu, t_gpu, a_gpu, c_gpu) = out["cpu"], out["cuda"]
    same_tokens = all(np.array_equal(x, y) for call_c, call_g in zip(d_cpu, d_gpu)
                      for x, y in zip(call_c, call_g))
    lengths, finished = d_gpu[-1][1], d_gpu[-1][2]
    err = max(float(np.abs(x - y).max()) for x, y in zip(a_gpu + c_gpu, a_cpu + c_cpu))
    ok = (same_tokens and t_gpu == t_cpu == [75, 100, 25, 25] and err <= 1e-3
          and lengths[1] == 0 and lengths[3] == 10 and bool(finished[3])
          and all(np.isfinite(a).all() for a in a_gpu))
    print(f"engine reference check (small config, fp32, card vs CPU plain path): slots_decode "
          f"on 4 slots over 2 x 16 steps, tokens/lengths/finished equal {same_tokens} (lengths "
          f"{lengths.tolist()}, finished {finished.tolist()}); _stream_chunk_batch at cursors "
          f"50 and 75 padded to 4 rows: cursors after {t_gpu} vs {t_cpu}, audio and caches "
          f"max_abs_err={err:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the card's slot decode or batched steady chunk disagrees with the "
                         "plain CPU path")


def _first_batch_shapes(engine, shapes: list) -> None:
    """Note in ``shapes`` the K1 shape of each of ``engine``'s batched first
    emissions (one streaming flow recompute on n_slots rows, pad rows
    repeating row 0, the CFG halves doubling them)."""
    from cosyvoice2_eu_torch.runtime.model import FLOW_TOKEN_BUCKETS, bucket_for

    inner = engine._first_batch
    cfg = engine.cfg
    la, ratio = cfg.flow.pre_lookahead_len, cfg.token_mel_ratio

    def recorded(group, tokens, lengths):
        totals = [req.session.P + req.session.this_hop + la for _, req in group]
        totals += [totals[0]] * (engine.n_slots - len(totals))
        shapes.append(((bucket_for(max(totals), FLOW_TOKEN_BUCKETS) - la) * ratio,
                       [(n - la) * ratio for n in totals] * 2,
                       cfg.flow.estimator.static_chunk_size))
        return inner(group, tokens, lengths)

    engine._first_batch = recorded


def _engine_requests(engine, prompts: list, card: str, what: str) -> dict:
    """Every prompt submitted to ``engine`` at once, each request read by a
    thread of its own that notes when each chunk arrives.  Gates: every
    request gives finite, non-silent float32 audio of exactly its tokens x
    960 samples, within 600 s.  Prints each request's time to first audio,
    steady chunk median (the gaps between chunks after the first, before
    the last), wall time and tokens, and the run's aggregate RTF, decode ms
    per ``slots_decode`` step, stage totals, batched rounds and peak memory.
    Returns the run's numbers."""
    import threading

    import numpy as np
    import torch

    tm = engine.model
    n = len(prompts)
    arrivals, chunks, errors = [[] for _ in prompts], [[] for _ in prompts], [None] * n
    step0 = engine.state.step
    tm.timer.reset()
    _reset_peak()
    t0 = time.perf_counter()
    handles = [engine.submit(p) for p in prompts]

    def read(i):
        try:
            for c in handles[i]:
                arrivals[i].append(time.perf_counter())
                chunks[i].append(c)
        except RuntimeError as e:
            errors[i] = e

    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(n)]
    for r in readers:
        r.start()
    for r in readers:
        r.join(600)
    wall = time.perf_counter() - t0
    if any(r.is_alive() for r in readers) or any(errors):
        raise SystemExit(f"{what}: a request failed or did not end within 600 s: {errors}")
    peak = torch.cuda.max_memory_allocated()
    steps = engine.state.step - step0
    stages = tm.timer.summary()
    counts = tm.timer.counts
    sr = tm.cfg.sample_rate
    ok, samples = True, 0
    for i, (h, cs, times) in enumerate(zip(handles, chunks, arrivals)):
        n_tok = h._req.harvested
        audio = np.concatenate(cs)
        samples += audio.size
        good = (audio.dtype == np.float32 and audio.size == n_tok * 960
                and np.isfinite(audio).all() and float(np.abs(audio).max()) > 1e-3)
        ok = ok and good
        gaps = sorted(b - a for a, b in zip(times[:-2], times[1:-1]))  # chunks 1 .. m-2
        steady = f"{gaps[len(gaps) // 2] * 1e3:.1f} ms" if gaps else "n/a"
        print(f"{what} request {i}: {n_tok} tokens, {audio.size / sr:.2f} s audio in {len(cs)} "
              f"chunks, time to first audio {(times[0] - t0) * 1e3:.1f} ms, steady chunk median "
              f"{steady}, wall {(times[-1] - t0):.2f} s [{card}] {'ok' if good else 'FAIL'}")
    audio_s = samples / sr
    rounds = {k: counts.get(k, 0) for k in ("eng_first_batch", "eng_steady_batch")}
    decode_s = stages["eng_decode"]["total_s"]
    print(f"{what}: {n} requests on {engine.n_slots} slots, {audio_s:.2f} s audio in {wall:.2f} s "
          f"wall, aggregate RTF {wall / audio_s:.3f}; {steps} slots_decode steps at "
          f"{engine.n_slots} rows, {decode_s * 1e3 / max(steps, 1):.2f} ms a step; batched "
          f"rounds {rounds}; stage totals ms: " + ", ".join(
              f"{k} {stages[k]['total_s'] * 1e3:.1f}/{stages[k]['count']}"
              for k in ("eng_prefill", "eng_decode", "eng_first_batch", "eng_steady_batch",
                        "eng_feed") if k in stages)
          + f"; peak memory {peak / 2**30:.2f} GiB [{card}] {'ok' if ok else 'FAIL'}")
    if not ok or not all(rounds.values()):
        raise SystemExit(f"{what}: a request failed its checks, or no batched first or steady "
                         "round ran")
    return {"steps": steps, "prefills": counts.get("eng_prefill", 0), "audio_s": audio_s,
            "wall": wall, "rounds": rounds}


def engine_path(card: str) -> tuple[list, int, list, int]:
    """The continuous-batching engine at the published widths, the weights
    of ``load(seed=0)`` and the 3 s prompt: ``TTSEngine(n_slots=4,
    chunk_steps=25, max_cache=1024, max_gen=640)`` on the bf16 LM takes 5
    requests at once (160 to 280 tokens: one waits staged for a slot);
    then ``serve_stdlib`` over ``EngineAPI`` on 127.0.0.1 answers a
    zero-shot POST of the 3 s wav (the frontend models of the frontend
    phase, seeded), which must be non-empty, non-silent int16 PCM of whole
    tokens (1920 bytes a token); then a fresh int8 model's engine takes 2
    requests on 4 slots, so every batched group is padded.  Gates, with the
    counts set to 0 before the phase and read after: K1 560 times a flow
    call (the batched first emissions on 4 rows and each request's own
    recomputes, all of its bf16 design), K2 168 times a ``prefill_row`` and
    169 times a decode step (at M = 4, on its designs), no K3 or K4.
    Returns K1's shapes and launches and K2's (batch, prompt bucket, steps)
    and launches."""
    import base64
    import http.client
    import threading

    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.frontend import frontend as fe_mod
    from cosyvoice2_eu_torch.models import campplus as cam
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.serving.engine import EngineAPI, TTSEngine
    from cosyvoice2_eu_torch.serving.http_server import serve_stdlib

    cfg = TTSConfig()
    n_layers = cfg.llm.backbone.num_layers
    per_prefill, per_step = 7 * n_layers, 7 * n_layers + 1
    prompt = _prompt(cfg, 3.0)
    texts = ("Bonjour!", "Hallo Welt", "Guten Tag!", "Bonjour, Paris", "Salut a tous")
    _reset_counts()
    K2_LAUNCHED.clear()
    calls, shapes = [], []  # the requests' own flow calls; the batched first emissions' K1
    model = cosy.load(config=cfg, seed=0, device="cuda")
    tm = model._model
    _record_flow_calls(tm, calls)
    engine = TTSEngine(tm, n_slots=4, chunk_steps=25, max_cache=1024, max_gen=640)
    _first_batch_shapes(engine, shapes)
    try:
        inputs = [model._frontend.frontend_zero_shot(t, prompt) for t in texts]
        run = _engine_requests(engine, inputs, card, "engine bf16")
    finally:
        engine.close()

    # HTTP: a wav prompt through the frontend models, the engine behind the server
    st_cfg, cam_cfg = st.SpeechTokenizerConfig(), cam.CAMPPlusConfig()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fe = fe_mod.Frontend(cfg, tokenizer=model._frontend.tokenizer,
                         speech_tokenizer_fn=fe_mod.make_speech_tokenizer_fn(
                             st.init_speech_tokenizer(gen, st_cfg), st_cfg, device="cuda"),
                         spk_embedding_fn=fe_mod.make_spk_embedding_fn(
                             _perturbed_norms(cam.init_campplus(gen, cam_cfg), gen), cam_cfg,
                             device="cuda"), device="cuda")
    api = EngineAPI(cosy.Cosy2EU(tm, fe, cfg), n_slots=4, chunk_steps=25, max_cache=1024,
                    max_gen=640)
    _first_batch_shapes(api.engine, shapes)
    server = serve_stdlib(api, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with tempfile.TemporaryDirectory(prefix="cosy_http_") as d:
            with open(write_prompt_wavs(d)["3s"][0], "rb") as f:
                wav_b64 = base64.b64encode(f.read()).decode()
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/inference_zero_shot", json.dumps(
            {"tts_text": "Bonjour!", "prompt_text": "Bonjour, je m'appelle Claire.",
             "prompt_wav_b64": wav_b64}))
        resp = conn.getresponse()
        first = resp.read(2)
        t_first = time.perf_counter() - t0
        body = first + resp.read()
        wall = time.perf_counter() - t0
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
        api.close()
    pcm = np.frombuffer(body, np.int16).astype(np.int32)
    ok = (resp.status == 200 and len(body) > 0 and len(body) % 1920 == 0
          and int(np.abs(pcm).max(initial=0)) > 32)
    print(f"HTTP: serve_stdlib over EngineAPI on 127.0.0.1, one zero-shot POST of the 3 s wav: "
          f"status {resp.status}, {len(body)} bytes = {len(body) / 1920:.1f} tokens of int16 PCM "
          f"({len(pcm) / cfg.sample_rate:.2f} s), peak |x| {int(np.abs(pcm).max(initial=0))}, "
          f"first bytes after {t_first * 1e3:.1f} ms, wall {wall:.2f} s [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the HTTP round trip through the engine failed its checks")
    del model, tm, api, fe, engine
    gc.collect()
    torch.cuda.empty_cache()

    # int8: 2 requests on 4 slots, every group padded
    model = cosy.load(config=cfg, seed=0, device="cuda", lm_quant="int8")
    tm = model._model
    _record_flow_calls(tm, calls)
    engine = TTSEngine(tm, n_slots=4, chunk_steps=25, max_cache=1024, max_gen=640)
    _first_batch_shapes(engine, shapes)
    k2_before = _counters()[3].launches
    try:
        inputs = [model._frontend.frontend_zero_shot(t, prompt) for t in texts[1:3]]
        run8 = _engine_requests(engine, inputs, card, "engine int8")
    finally:
        engine.close()
    k2 = _counters()[3].launches - k2_before
    want_k2 = per_prefill * run8["prefills"] + per_step * run8["steps"]
    # K2's shapes: each prefill_row at M = its prompt bucket, each step at M = 4
    p_buckets = [tm._pack_lm_prompt(p)[3] for p in inputs]
    decodes = [(1, pb, 0) for pb in p_buckets] + [(engine.n_slots, 0, run8["steps"])]
    designs = _k2_designs(set(p_buckets), _counters()[3].launches)
    print(f"engine int8: K2 launches {k2} (expected {per_prefill} x {run8['prefills']} "
          f"prefill_row + {per_step} x {run8['steps']} steps = {want_k2}; by M, as recorded at "
          f"each launch: {designs}) [{card}]")
    if k2 != want_k2:
        raise SystemExit("engine int8: K2 launches do not match its prefills and decode steps")
    del model, tm, engine
    gc.collect()
    torch.cuda.empty_cache()

    launches = [f.launches for f in _counters()]
    flows = len(calls) + len(shapes)  # each request's own recomputes, the batched ones
    want = _k1_per_flow(cfg) * flows
    print(f"engine phase: K1/K3/K4/K2 launches {launches} (K1 expected {want} = 560 x {flows} "
          f"flow calls, {len(shapes)} of them batched first emissions on 4 rows; "
          f"{_k1_design()}) [{card}]")
    if launches[0] != want or any(launches[1:3]):
        raise SystemExit("engine phase: K1 launches do not match its flow calls, or a backward "
                         "kernel ran")
    shapes += [_k1_shape(cfg, *c[:3]) for c in calls]
    return shapes, launches[0], decodes, launches[3]


def batch6_path(card: str) -> tuple[list, int]:
    """One ``tts_batch`` of 6 short zero-shot prompts (their own speakers)
    at the published widths: one LM decode and one flow call at B=6, and
    HiFT on one sub-batch of 6 rows, past the 4 rows earlier runs gave it.
    Gates: tokens x 960 samples per row, finite, non-silent; K1 560 times
    the flow call.  Returns the flow call's K1 shape and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.runtime.model import FLOW_TOKEN_BUCKETS, HIFT_MEL_BUCKETS, bucket_for

    cfg = TTSConfig()
    model = cosy.load(config=cfg, seed=0, device="cuda")
    tm = model._model
    texts = ("Oui.", "Non.", "Merci!", "Danke.", "Hallo!", "Salut!")
    prompts = [model._frontend.frontend_zero_shot(t, _prompt(cfg, 3.0, seed))
               for seed, t in enumerate(texts)]
    _reset_counts()
    tm.timer.reset()
    _reset_peak()
    t0 = time.perf_counter()
    wavs = tm.tts_batch(prompts)
    wall = time.perf_counter() - t0
    n_toks = tm.last_batch_tokens
    totals = [len(p.flow_prompt_speech_tokens) + n for p, n in zip(prompts, n_toks)]
    h_bucket = bucket_for(max(n_toks) * cfg.token_mel_ratio, HIFT_MEL_BUCKETS)
    sub = max(1, min(len(prompts), int(4 * 2048 / h_bucket)))
    hift = tm.timer.summary()["hift"]
    ok = (all(w.size == n * 960 and np.isfinite(w).all() and float(np.abs(w).max()) > 1e-3
              for w, n in zip(wavs, n_toks)) and sub > 4 and hift["count"] == 1)
    print(f"tts_batch of 6: tokens {n_toks}, samples {[w.size for w in wavs]}, HiFT bucket "
          f"{h_bucket} in {hift['count']} call of {sub} rows ({hift['total_s'] * 1e3:.1f} ms), "
          f"wall {wall:.2f} s, RTF {wall / (sum(w.size for w in wavs) / cfg.sample_rate):.3f}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("tts_batch of 6 failed its checks")
    launches = _path_launches("tts_batch of 6", card, 1)
    t_mel = bucket_for(max(totals), FLOW_TOKEN_BUCKETS) * cfg.token_mel_ratio
    del model, tm
    gc.collect()
    torch.cuda.empty_cache()
    return [(t_mel, [n * cfg.token_mel_ratio for n in totals] * 2, 0)], launches


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
def time_training_kernels(paths: dict, card: str) -> tuple[dict, dict, dict, list]:
    """K1 (with LSE), K3, K4, their plain versions and the library's forward
    and backward at every (lengths, chunk) the training paths ran, fp32, and
    K1 without LSE at their CV batches; then bf16 at the training path's
    batches at chunk 0 for comparison with K1's serving times.  ``paths``
    maps a path's name to (its step records, with "lens" and "chunk"; K1's
    launches over it, CV included; its CV batches' lengths); each step
    launches each kernel equally often, and so does each CV batch.  Returns
    K1's times per path (means per launch), K3's and K4's rows of the
    kernels line (means per launch over the paths, each path's under
    ``by_path``) and each step of the "train" path's (K1 + K3 + K4) ms per
    layer."""
    import torch
    import torch.nn.functional as F

    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.ops.masks import chunk_attention_mask

    h, d = 8, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    timed = {}

    def timed_at(lens, chunk, dtype, t=None):
        """K1 + LSE, K3 and K4 at one shape (T: ``t``, else the longest
        row), timed once."""
        lens = tuple(lens)
        t = t or max(lens)
        if (lens, chunk, dtype, t) in timed:
            return timed[(lens, chunk, dtype, t)]
        b = len(lens)
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
                ms=_graph_ms(lambda i: launch(), 20), eager_ms=_cuda_ms(launch, 20),
                plain_ms=_cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, do, lse, delta, lengths, chunk, grads=grads), 5),
                library_ms=None, bound_ms=max(ops_ms, bytes_ms),
                fma_bound_ms=max(ops / H100_FP32_FLOPS * 1e3, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms, gflop=ops / 1e9, **backward)
        r = timed[(lens, chunk, dtype, t)] = dict(k1=k1, **kern)
        k3, k4 = kern["K3"], kern["K4"]
        print(f"K1/K3/K4 timing lengths={list(lens)} T={t} {str(dtype)[6:]} chunk={chunk} [{card}]: "
              f"K1+LSE {k1['ms']:.4f} ms ({k1['tflops']:.1f} TFLOP/s, {100 * k1['share']:.1f}% of "
              f"the bound; plain {k1['plain_ms']:.4f}, sdpa forward {k1['library_ms']:.4f}, bound "
              f"{k1['bound_ms'] * 1e3:.1f} us, FMA bound {k1['fma_bound_ms'] * 1e3:.1f} us); "
              + "; ".join(
                  f"{name} {r['ms']:.4f} ms replayed, {r['eager_ms']:.4f} eager ({r['gflop']:.2f} "
                  f"GFLOP, {r['gflop'] / r['ms']:.1f} TFLOP/s, {100 * r['bound_ms'] / r['ms']:.1f}% "
                  f"of the bound; plain {what} {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms'] * 1e3:.1f} us, FMA bound {r['fma_bound_ms'] * 1e3:.1f} us)"
                  for name, what, r in (("K3", "dQ", k3), ("K4", "dK/dV", k4)))
              + f"; whole backward: delta+K3+K4 {backward['backward_ms']:.4f} ms, plain "
              f"{backward['backward_plain_ms']:.4f} ms, sdpa {backward['backward_library_ms']:.4f}"
              f" ms; bounds at {'3xTF32' if dtype == torch.float32 else 'bf16 tensor-core'} "
              f"{PEAKS[str(dtype)] / 1e12:.0f} TFLOP/s (FMA bound at "
              f"{H100_FP32_FLOPS / 1e12:.0f}) and HBM {H100_BYTES / 1e12:.2f} TB/s")
        return r

    k1_paths, bwd_parts = {}, {}
    for name, (steps, k1_launches, cv_lens) in paths.items():
        per_step = [timed_at(r["lens"], r["chunk"], torch.float32, r.get("t")) for r in steps]
        n = k1_launches // (len(steps) + len(cv_lens))  # each kernel's launches per step
        cv_parts = []
        for lens in cv_lens:
            cv = _time_k1(lens, max(lens), 0, torch.float32, False, gen)
            print(f"K1 timing ({name} CV batch, no LSE) lengths={list(lens)} fp32 chunk=0 "
                  f"[{card}]: kernel {cv['ms']:.4f} ms ({cv['tflops']:.1f} TFLOP/s, "
                  f"{100 * cv['share']:.1f}% of the bound), plain {cv['plain_ms']:.4f} ms, sdpa "
                  f"{cv['library_ms']:.4f} ms, bound {cv['bound_ms'] * 1e3:.1f} us, FMA bound "
                  f"{cv['fma_bound_ms'] * 1e3:.1f} us")
            cv_parts.append((n, cv))
        k1_paths[name] = _weighted([(n, p["k1"]) for p in per_step] + cv_parts)
        bwd_parts[name] = {key: [(n, p[key]) for p in per_step] for key in ("K3", "K4")}
    if "train" in paths:
        for lens in TRAIN_SHAPES:
            timed_at(lens, 0, torch.bfloat16)
    rows = []
    for key, name, line in (("K3", "flash_attention_dq", 125), ("K4", "flash_attention_dkv", 172)):
        times = _weighted([part for parts in bwd_parts.values() for part in parts[key]])
        by_path = {path: {k: v for k, v in _weighted(parts[key]).items()
                          if k in ("launches", "ms", "eager_ms", "plain_ms", "bound_ms",
                                   "fma_bound_ms", "bound_by", "library_ms")}
                   for path, parts in bwd_parts.items()}
        rows.append(_kernel_row(name, "flash_attention_bwd.cu", f"flash_attention.py:{line}",
                                times, eager_ms=times["eager_ms"],
                                fma_bound_ms=times["fma_bound_ms"], by_path=by_path))
    step_kernel_ms = [p["k1"]["ms"] + p["K3"]["ms"] + p["K4"]["ms"]
                      for p in (timed_at(r["lens"], r["chunk"], torch.float32)
                                for r in paths.get("train", ([], 0, []))[0])]
    return k1_paths, rows[0], rows[1], step_kernel_ms


def _time_k2(m: int, n: int, k: int, gen) -> dict:
    """K2, its plain version, ``torch._weight_int8pack_mm`` and ``F.linear``
    on bf16 weights at one (M, N, K), x in bf16 (device ms per call), after
    K2's output at this shape is held against the plain one (``err``; a
    disagreement ends the run) and the design it took noted.  At a decode
    shape (M <= 8) also the FMA design ``int8_matmul.cu``, which served
    decode before the decode design, launched directly (``fma_ms``; None
    elsewhere), after its output is held to the same tolerance.  Each
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
               plain_ms=_graph_ms(lambda i: i8.int8_matmul_reference(x, w_q[i]), copies),
               fma_ms=None)
    if m <= i8.DECODE_ROWS:  # the design decode took before, on the same inputs
        y = torch.empty((m, n), dtype=torch.float32, device="cuda")
        fma_err = (i8._launch(i8.SOURCE, x, w_q[0], y), (y - want).abs().max().item())
        if fma_err[0] != 0 or not fma_err[1] <= tol:
            raise SystemExit(f"K2's FMA design fails at M={m} N={n} K={k}: {fma_err}")
        out["fma_ms"] = _graph_ms(lambda i: i8._launch(i8.SOURCE, x, w_q[i], y), copies)
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
    """K2 at every (M, N, K) the int8 path, the int8 stream and the int8
    engine ran, weighted by its launches there.

    ``decodes`` holds each LM decode's (batch, prompt bucket, steps), and
    optionally its backbone config (default, or None: Qwen2-0.5B) and its
    tensor-parallel size (one process's slices; default 1): the prefill runs
    the 7 projections of each layer at M = batch x bucket, each decode step
    runs them and the speech head at M = batch (the engine's
    ``prefill_row`` is (1, bucket, 0) and its slot decode (4, 0, steps); a
    bistream extend (1, 64, 0)).  Returns the
    kernels line's mean per launch, with each shape's times under by_shape
    and each design's means per launch under by_design."""
    import torch


    counts: dict = {}

    def add(shape, c):
        if c and shape[0]:  # a prefill alone (steps 0) or a decode alone (bucket 0)
            counts[shape] = counts.get(shape, 0) + c

    for b, p_bucket, steps, *rest in decodes:
        cfg = _with_backbone(rest[0] if rest else None)
        n_layers = cfg.llm.backbone.num_layers
        for n, k, per_layer in _k2_shapes(cfg, rest[1] if len(rest) > 1 else 1):
            if per_layer:  # a projection of every layer: at prefill and at each step
                add((b * p_bucket, n, k), n_layers * per_layer)
                add((b, n, k), n_layers * per_layer * steps)
            else:  # the speech head, once per step
                add((b, n, k), steps)
    if sum(counts.values()) != launches:
        raise SystemExit(f"K2's launches on the int8 paths ({launches}) do not match its shapes "
                         f"({sum(counts.values())})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    parts, notes = [], set()
    for (m, n, k), c in sorted(counts.items()):
        r = _time_k2(m, n, k, gen)
        notes.add(r.pop("library_note"))
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        fma = "" if r["fma_ms"] is None else (
            f"FMA design {r['fma_ms']:.4f} ms (K2 {r['fma_ms'] / r['ms']:.2f}x faster), ")
        vs = r["ms"] / r["bf16_linear_ms"]
        print(f"K2 timing M={m} N={n} K={k} x bf16 ({r['source']}), weights cold, {c} launches "
              f"on the int8 paths [{card}]: kernel {r['ms']:.4f} ms ({r['mb'] / r['ms']:.0f} "
              f"GB/s, {r['tflops']:.1f} TFLOP/s, {100 * r['share']:.1f}% of the bound), plain "
              f"{r['plain_ms']:.4f} ms, {fma}_weight_int8pack_mm {lib}, bf16 F.linear "
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
    out = _weighted([(c, {key: v for key, v in r.items() if key != "fma_ms"}) for c, r in parts])
    keys = ("ms", "plain_ms", "library_ms", "bf16_linear_ms", "bound_ms")
    out["by_shape"] = [{"m": r["m"], "n": r["n"], "k": r["k"], "source": r["source"],
                        "launches": c, **{key: r[key] for key in keys + ("fma_ms",)}}
                       for c, r in parts]
    out["by_design"] = {}
    for source in sorted({r["source"] for _, r in parts}):
        mean = _weighted([(c, {key: v for key, v in r.items() if key != "fma_ms"})
                          for c, r in parts if r["source"] == source])
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


def _print_decode_step(by_shape: list, card: str) -> None:
    """K2's time summed over the launches of one decode step (7 projections
    x layers and the speech head at M = 1 and 4), beside the FMA design's,
    bf16 ``F.linear``'s and the bound's on the same shapes."""
    from cosyvoice2_eu_torch.config import TTSConfig

    cfg = TTSConfig()
    n_layers = cfg.llm.backbone.num_layers
    for m in sorted({r["m"] for r in by_shape if r["fma_ms"] is not None}):
        rows = {(r["n"], r["k"]): r for r in by_shape if r["m"] == m}
        per = [(n_layers * c if c else 1, rows[(n, k)]) for n, k, c in _k2_shapes(cfg)]
        total = {key: sum(c * r[key] for c, r in per)
                 for key in ("ms", "fma_ms", "bf16_linear_ms", "bound_ms")}
        print(f"int8 decode step M={m}: K2 summed over its {sum(c for c, _ in per)} launches "
              f"{total['ms']:.4f} ms (FMA design {total['fma_ms']:.4f} ms, bf16 F.linear on the "
              f"same shapes {total['bf16_linear_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms) "
              f"[{card}]")


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


# ---------------------------------------------------------------------------
# the optimizer's passes
# ---------------------------------------------------------------------------

def _optimizer_pass_errors(layout, grads: list, g, a, mu, nu, p, h) -> dict:
    """Each mode of the two passes on the card against the plain version on
    the same flat buffers (``g``: ``grads`` flat): pass A accumulating
    (ACC), emitting (EMIT) and summing the gradient alone (NORM); pass B
    from the flat mean with the reset, and from ``grads`` through the
    address table (``accum_grad`` 1).  The means, mu and nu as their
    largest error over their largest entry; the parameters' update
    (``p_new - p``) likewise, over the largest update; the sums relative,
    each; the reset's largest entry (0 where the mean is finite).  A
    non-finite error reads inf."""
    from cosyvoice2_eu_torch.ops import optim_passes as op

    def finite(err) -> float:
        return float(err) if math.isfinite(float(err)) else math.inf

    rel = lambda got, ref: finite((got - ref).abs().max() / ref.abs().max())  # noqa: E731
    table, _ = op.grad_table(layout, grads)
    errs = {"sums": 0.0, "mean": 0.0, "mu": 0.0, "nu": 0.0, "update": 0.0}
    for mode, a_in in ((op.EMIT, a), (op.ACC, a), (op.NORM, None)):
        mean, sums = op.launch_accumulate(layout, table, a_in, 2, mode)
        want_mean, want = op.accumulate_reference(g, a_in, 2, mode != op.ACC)
        errs["sums"] = max(errs["sums"], finite(((sums - want).abs()
                                                 / want.abs().clamp_min(1e-30)).max()))
        if mean is not None:
            errs["mean"] = max(errs["mean"], rel(mean, want_mean))
        del mean, want_mean
    mean = op.running_mean(g, a, 2)
    for src, launch in (("mean", lambda: op.launch_update(layout, None, mean, mu, nu, p, h, True)),
                        ("table", lambda: op.launch_update(layout, table, None, mu, nu, p, h,
                                                           False))):
        mu2, nu2, p2, a0 = launch()
        mu_ref, nu_ref, p_ref = op.adam_update(mean if src == "mean" else g, mu, nu, p, h)
        errs["mu"] = max(errs["mu"], rel(mu2, mu_ref))
        errs["nu"] = max(errs["nu"], rel(nu2, nu_ref))
        del mu2, nu2, mu_ref, nu_ref
        errs["update"] = max(errs["update"], rel(p2 - p, p_ref - p))
        del p2, p_ref
        if src == "mean":
            errs["reset"] = finite(a0.abs().max())
        del a0
    return errs


def time_optimizer_passes(card: str) -> dict:
    """The optimizer's fused passes (``csrc/optim_passes.cu``) at the flow's
    tree (``TTSConfig().flow``) and the Qwen3-0.6B LM's (the trees the
    benchmark's training cells update), on random flat state.  First every
    mode of each pass against its plain version (``_optimizer_pass_errors``)
    at lr 1e-2, the clip and AdamW's decay on, every 97th gradient element
    scaled by 1e-9 (where eps shapes the update): the means, mu and nu
    within 1e-6 of their largest entry (the plain version divides by a
    scalar as a product with its reciprocal on the card), the sums within
    1e-6 relative, the reset exactly 0, and the update within 1e-3 of the
    largest update (~0.35 lr): the parameters (up to ~6) are rounded once
    to fp32 on each side, ~4.8e-7 apart at most, ~1.4e-4 of it, while a
    wrong lr, decay, bias correction or eps, or parameters left as they
    were, is 10-100% of it.  Then pass A (accumulating, mode ACC) and pass
    B (from the mean, the reset written) as CUDA-graph replay against their
    byte bound (12 and 32 bytes a leaf element), beside the plain version
    and ``torch._fused_adamw_`` (in place, no clip or mean) on the same
    buffers.  The passes' launch counts are left as they were.  Returns
    the kernels line's row: ``launches``, the passes' launches on the
    training paths (``by_path``: each path's micro-steps and finite
    emissions beside them); ``ms``, ``bound_ms``, pass A plus pass B, the
    mean of the two trees (each tree's under ``by_tree``)."""
    import torch

    from cosyvoice2_eu_torch.config import qwen3_0_6b_config
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.llm import init_lm
    from cosyvoice2_eu_torch.ops import optim_passes as op
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    saved = op.accumulate.launches, op.update.launches
    gen = torch.Generator(device="cuda").manual_seed(0)
    trees = {"flow": lambda: init_flow(gen, _with_backbone().flow),
             "lm": lambda: init_lm(gen, _with_backbone(qwen3_0_6b_config()).llm)}
    h = op.Hyper(norm=10.0, max_norm=5.0, b1=0.9, b2=0.999, bc1=0.271, bc2=0.003996,
                 eps=1e-8, weight_decay=0.01, lr=1e-2)
    by_tree, worst = {}, 0.0
    for name, make in trees.items():
        leaves = tree_leaves(make())
        layout = op.FlatLayout(leaves)
        n = sum(layout.numels)
        grads = [torch.randn(x.shape, generator=gen, device="cuda") for x in leaves]
        for x in grads:
            x.view(-1)[::97] *= 1e-9
        p = layout.flatten(leaves)
        del leaves
        g = layout.flatten(grads)
        a, mu = g * 0.5, g * 0.1
        nu = g * g * 0.01
        errs = _optimizer_pass_errors(layout, grads, g, a, mu, nu, p, h)
        ok = (max(errs["sums"], errs["mean"], errs["mu"], errs["nu"]) <= 1e-6
              and errs["update"] <= 1e-3 and errs["reset"] == 0.0)
        worst = max(worst, errs["mean"], errs["mu"], errs["nu"])
        table, _ = op.grad_table(layout, grads)
        a_ms = _graph_ms(lambda i: op.launch_accumulate(layout, table, a, 2, op.ACC), 10)
        b_ms = _graph_ms(lambda i: op.launch_update(layout, None, a, mu, nu, p, h, True), 10)
        plain_ms = (_cuda_ms(lambda: op.running_mean(g, a, 2), 3)
                    + _cuda_ms(lambda: op.adam_update(a, mu, nu, p, h), 3))
        step = torch.ones((), device="cuda")
        lib = [p.clone(), a, mu.clone(), nu.clone()]
        library_ms = _cuda_ms(lambda: torch._fused_adamw_(
            [lib[0]], [lib[1]], [lib[2]], [lib[3]], [], [step], lr=h.lr, beta1=h.b1,
            beta2=h.b2, weight_decay=0.01, eps=h.eps, amsgrad=False, maximize=False), 3)
        bound = {"a": 12 * n / H100_BYTES * 1e3, "b": 32 * n / H100_BYTES * 1e3}
        by_tree[name] = {"leaves": len(layout.numels), "elements": n, "pass_a_ms": a_ms,
                         "pass_a_bound_ms": bound["a"], "pass_b_ms": b_ms,
                         "pass_b_bound_ms": bound["b"], "plain_ms": plain_ms,
                         "library_ms": library_ms, "errors": errs}
        print(f"optimizer passes, {name} tree ({len(layout.numels)} leaves, {n:,} elements): "
              f"pass A {a_ms:.4f} ms (bound {bound['a']:.4f}, {100 * bound['a'] / a_ms:.1f}%), "
              f"pass B {b_ms:.4f} ms (bound {bound['b']:.4f}, {100 * bound['b'] / b_ms:.1f}%); "
              f"plain {plain_ms:.4f} ms, torch._fused_adamw_ {library_ms:.4f} ms; against the "
              f"plain version (A: ACC, EMIT, NORM; B: from the mean, from the table): sums "
              f"{errs['sums']:.1e}, mean {errs['mean']:.1e}, mu {errs['mu']:.1e}, nu "
              f"{errs['nu']:.1e} (tol 1e-6), update {errs['update']:.1e} (tol 1e-3 of the "
              f"largest), reset {errs['reset']} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the optimizer's passes disagree with their plain version")
        del p, g, a, mu, nu, table, grads, lib
        torch.cuda.empty_cache()
    op.accumulate.launches, op.update.launches = saved
    mean_of = lambda key: sum(t[key] for t in by_tree.values()) / len(by_tree)  # noqa: E731
    return {"name": "optimizer_passes", "route": "cuda",
            "source": f"cosyvoice2_eu_torch/csrc/{op.SOURCE}", "replaces": None,
            "launches": sum(sum(c["pass_a"] + c["pass_b"] for c in counts)
                            for counts in OPTIMIZER_BY_PATH.values()),
            "max_abs_err": worst,
            "ms": mean_of("pass_a_ms") + mean_of("pass_b_ms"),
            "plain_ms": mean_of("plain_ms"),
            "bound_ms": mean_of("pass_a_bound_ms") + mean_of("pass_b_bound_ms"),
            "bound_by": "bytes", "library_ms": mean_of("library_ms"), "by_tree": by_tree,
            "by_path": {path: _summed(counts) for path, counts in OPTIMIZER_BY_PATH.items()}}


# ---------------------------------------------------------------------------
# bistream (streaming text in) and the speech LM's training
# ---------------------------------------------------------------------------

# Random weights do not ask for text: the speech head's FILL logit is as
# likely as any other of its ids, so a bistream request would decode until
# its cache is full on the first text piece, and the next extend would not
# fit (the port raises ValueError there; the JAX package clamps its write).
# The bistream phases raise the head's bias at FILL and EOS by this much, as
# a trained head asks for text and stops: about one nucleus draw in 13 is
# FILL at the published widths (24 of the top 25 logits ~1.8, FILL's
# ~2.5 + its own), after the first FILL forced fills follow every 16 tokens,
# and the final segment ends on EOS.
PROTOCOL_BIAS = 2.5
SMALL_BIAS = 1.0
# a French sentence of 60-100 bytes, fed word by word to ``stream_text``
STREAM_TEXT = "Bonjour, je vous lis ce texte mot par mot pendant que le modèle parle."


def _protocol_bias(llm: dict, cfg, by: float = PROTOCOL_BIAS) -> None:
    """Raise ``llm``'s speech-head bias at FILL and EOS by ``by`` (in place:
    every model that shares these parameters sees it)."""
    import torch

    ids = torch.tensor([cfg.eos_token, cfg.speech_token_size + 2])
    bias = llm["llm_decoder"]["bias"]
    bias[ids.to(bias.device)] += by


def _words(text: str):
    """``text`` as the pieces an upstream LLM would send: each word with its space."""
    return iter(w + " " for w in text.split())


@_uncounted
def check_small_bistream() -> None:
    """Bistream and the LM's training on the card against the plain CPU path
    on the small config of ``check_small_stream`` (fp32, the head's
    protocol bias, the same weights and draws): ``lm_inference_bistream``
    tokens equal; ``tts_stream_text`` chunks equal in length and audio
    within 1e-3; the same with ``lm_quant="int8"`` (K2 on the card: fp32 x,
    extends at M = 64 on the FMA design, decode at M = 1 on the decode
    design), with equal int8 codes; one LM train step, one LoRA step and one
    DPO step (accum_grad 1): loss within 1e-5 relative, each gradient leaf
    (Adam's first moment, 0.1 x the clipped gradient) within 1e-4 x max + 1e-7."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.config import TrainConfig
    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.ops.sampling import gumbel
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state
    from cosyvoice2_eu_torch.runtime.model import TTSModel
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.train.sequences import build_lm_batch
    from cosyvoice2_eu_torch.train.train import make_lm_step_fn
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map

    resolve_device("cuda")
    cfg, params, hift_draws = _small_stream_setup()
    lm = cfg.llm
    # the small head has 84 ids, so a smaller push keeps requests of a few chunks
    _protocol_bias(params["llm"], lm, SMALL_BIAS)
    g = torch.Generator(device="cpu").manual_seed(2)
    noise = [(gumbel((1, lm.top_k), g), gumbel((1, lm.full_vocab), g)) for _ in range(512)]
    fe = Frontend(cfg, device="cpu")  # its tokenizer only
    prompt = fe.frontend_zero_shot("", _prompt(cfg, 0.72, 4))
    pieces = [fe.text_tokens(w) for w in _words("Bonjour tout le monde, comment allez-vous ?")]

    for quant in (None, "int8"):
        out = {}
        for dev in ("cpu", "cuda"):
            tm = TTSModel(cfg, params, seed=0, compute_dtype=None, device=dev, lm_quant=quant)
            draws = lambda step: tuple(x.to(dev) for x in noise[step])  # noqa: E731
            toks = list(llm_mod.lm_inference_bistream(
                tm.params["llm"], lm, iter(pieces), prompt.prompt_text_tokens,
                prompt.llm_prompt_speech_tokens, draws=draws, max_cache=lm.max_seq_len))
            chunks = list(tm.tts_stream_text(iter(pieces), prompt, lm_draws=draws,
                                             hift_draws=hift_draws(dev)))
            out[dev] = (toks, chunks, tm.last_n_tokens, [x.cpu() for x in
                                                         tree_leaves(tm.params["llm"])])
        (t_cpu, c_cpu, n_cpu, llm_cpu), (t_gpu, c_gpu, n_gpu, llm_gpu) = out["cpu"], out["cuda"]
        same_len = [len(c) for c in c_cpu] == [len(c) for c in c_gpu]
        err = max(float(np.abs(a - b).max()) for a, b in zip(c_cpu, c_gpu)) if same_len \
            else float("inf")
        codes = all(torch.equal(a, b) for a, b in zip(llm_gpu, llm_cpu))
        ok = (t_cpu == t_gpu and len(t_gpu) > 0 and n_cpu == n_gpu == len(t_gpu) and same_len
              and err <= 1e-3 and codes and all(np.isfinite(c).all() for c in c_gpu))
        print(f"bistream reference check (small config, fp32, {quant or 'unquantized'} LM, card "
              f"vs CPU plain path): lm_inference_bistream {len(t_gpu)} tokens equal: "
              f"{t_cpu == t_gpu}; tts_stream_text {len(c_gpu)} chunks of "
              f"{[len(c) for c in c_gpu]} samples (equal lengths: {same_len}), audio "
              f"max_abs_err={err:.3e} (tol 1e-3); LM parameters (int8 codes and scales) equal: "
              f"{codes} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"bistream on the card ({quant or 'unquantized'}) disagrees with the "
                             "plain CPU path")

    tc = TrainConfig(lr=1e-3, accum_grad=1)
    rng = np.random.default_rng(6)
    texts = [rng.integers(2, lm.backbone.vocab_size, n) for n in (9, 12)]
    speeches = [rng.integers(0, lm.speech_token_size, n) for n in (40, 50)]
    rejects = [rng.integers(0, lm.speech_token_size, n) for n in (40, 50)]
    chosen = build_lm_batch(texts, speeches, lm, np.random.default_rng(1), 0.5, pad_to=80)
    rejected = build_lm_batch(texts, rejects, lm, np.random.default_rng(1), 0.5, pad_to=80)
    batch = dict(chosen, **{f"reject_{k}": v for k, v in rejected.items()})
    for mode in ("lm", "lora", "dpo"):
        out = {}
        for dev in ("cpu", "cuda"):
            tx = make_optimizer(tc)
            trained, step_fn, _ = make_lm_step_fn(
                lm, tc, tx, tree_map(lambda x: x.to(dev), params["llm"]), dpo=mode == "dpo",
                lora=mode == "lora", gen=torch.Generator(device="cpu").manual_seed(3))
            trained = tree_map(lambda x: x.to(dev), trained)
            state, m = step_fn(init_train_state(trained, tx),
                               {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        [x.cpu() for x in tree_leaves(state.opt_state["mu"])])
        (l_cpu, n_cpu, mu_cpu), (l_gpu, n_gpu, mu_gpu) = out["cpu"], out["cuda"]
        loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        worst = max((a - b).abs().max().item() / (1e-4 * b.abs().max().item() + 1e-7)
                    for a, b in zip(mu_gpu, mu_cpu))
        ok = math.isfinite(l_gpu) and loss_err <= 1e-5 and worst <= 1.0 and n_gpu > 0
        print(f"LM train reference check ({mode} step, small config, fp32, card vs CPU plain "
              f"path): loss {l_gpu:.6f} vs {l_cpu:.6f} (rel err {loss_err:.2e}, tol 1e-5), "
              f"grad_norm {n_gpu:.5f} vs {n_cpu:.5f}; {len(mu_gpu)} gradient leaves, the worst at "
              f"{worst:.3f} of its tolerance 1e-4 x max|g| + 1e-7 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the card's {mode} train step disagrees with the plain CPU path")


def _bistream_request(tm, chunks_fn, card: str, what: str, k2_per: tuple | None = None) -> dict:
    """One bistream request, ``chunks_fn()`` (waveform chunks), on the
    ``TTSModel`` ``tm``, with the counts set to 0 before it and read after,
    timed chunk by chunk.  Gates: tokens x 960 samples of finite, non-silent
    audio; K1 560 times a flow call, each launch of its bf16 design; no K3
    or K4; K2 none, or (int8) ``k2_per[0]`` launches an extend and
    ``k2_per[1]`` a decode step, every extend's (M = 64) on the wgmma design
    and every step's (M = 1) on the decode design.  Prints time to first
    audio, each chunk's wall ms and the steady median, RTF, LM ms/token, the
    extends and decode calls, and peak memory."""
    import numpy as np
    import torch

    calls: list = []
    _record_flow_calls(tm, calls)
    _reset_counts()
    K2_LAUNCHED.clear()
    _reset_peak()
    tm.timer.reset()
    walls: list = []
    t0 = time.perf_counter()
    chunks = [np.asarray(c).reshape(-1) for c in _timed_chunks(chunks_fn(), walls, [])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = [f.launches for f in _counters()]
    stages = tm.timer.summary()
    n_tok, steps = tm.last_n_tokens, tm.last_decode_steps
    extends, decodes = stages["bs_extend"]["count"], stages["bs_decode"]["count"]
    lm_s = stages["bs_extend"]["total_s"] + stages["bs_decode"]["total_s"]
    samples = sum(c.size for c in chunks)
    audio_s = samples / tm.cfg.sample_rate
    k1_want = _k1_per_flow(tm.cfg) * len(calls)
    k2_want = 0 if k2_per is None else k2_per[0] * extends + k2_per[1] * steps
    designs = _k2_designs({64}, launches[3]) if k2_per else "none"
    ok = (n_tok > 0 and samples == n_tok * 960 and all(
        c.dtype == np.float32 and c.size and np.isfinite(c).all() and float(np.abs(c).max()) > 1e-3
        for c in chunks) and calls and launches[0] == k1_want and launches[1:3] == [0, 0]
        and launches[3] == k2_want)
    between = sorted(walls[1:-1])  # the steady chunks: after the first, before the final
    steady = f", steady chunk median {between[len(between) // 2]:.1f} ms" if between else ""
    print(f"{what}: {n_tok} tokens in {steps} decode steps ({extends} extends, {decodes} decode "
          f"calls), {audio_s:.2f} s audio in {len(chunks)} chunks of "
          f"{[c.size for c in chunks]} samples; flow calls {len(calls)}, K1 launches "
          f"{launches[0]} (expected {_k1_per_flow(tm.cfg)} x {len(calls)}; {_k1_design()}); K2 "
          f"launches {launches[3]} (expected {k2_want}"
          + (f" = {k2_per[0]} x {extends} extends + {k2_per[1]} x {steps} steps; by M, as "
             f"recorded at each launch: {designs}" if k2_per else "") +
          f"); time to first audio {walls[0]:.1f} ms, chunk wall ms "
          f"[{', '.join(f'{w:.1f}' for w in walls)}]{steady}, RTF {wall / audio_s:.3f}, LM "
          f"{lm_s * 1e3 / n_tok:.2f} ms/token (extends {stages['bs_extend']['total_s'] * 1e3:.1f} "
          f"ms, decode {stages['bs_decode']['total_s'] * 1e3:.1f} ms), peak memory "
          f"{peak / 2**30:.2f} GiB [{card}] {'ok' if ok else 'FAIL'}")
    print(f"{what} stages (ms total / count): "
          + ", ".join(f"{k} {v['total_s'] * 1e3:.1f}/{v['count']}" for k, v in stages.items()))
    if not ok:
        raise SystemExit(f"{what} failed its checks")
    return {"shapes": [_k1_shape(tm.cfg, *c[:3]) for c in calls], "launches": launches[0],
            "k2": launches[3], "extends": extends, "steps": steps}


def bistream_path(card: str, backbone=None) -> tuple[list, int, list, int]:
    """Bistream at the published widths (bf16, the 3 s prompt, the head's
    protocol bias): with the default backbone (Qwen2-0.5B BlankEN) one
    ``Cosy2EU.stream_text`` request fed ``STREAM_TEXT`` word by word, one
    ``TTSModel(use_bistream=True).tts(stream=False)`` of it, and one int8
    ``stream_text`` (K2 168 launches an extend, 169 a step); with
    ``backbone="hf:Qwen/Qwen3-0.6B"`` (28 layers, hidden 1024, head dim 128,
    q/k norms, random weights) one bf16 and one int8 ``stream_text`` (K2
    196 and 197).  Returns K1's shapes and launches, and K2's decodes (as
    ``time_int8_matmul`` takes them: each extend's (1, 64, 0, backbone),
    the steps' (1, 0, steps, backbone)) and launches."""
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.runtime.model import TTSModel

    cfg = TTSConfig()
    prompt = _prompt(cfg, 3.0)
    name = "qwen3" if backbone else "bistream"
    runs, k2_decodes, k2 = [], [], 0
    for quant in (None, "int8"):
        t0 = time.perf_counter()
        model = cosy.load(config=cfg, seed=0, device="cuda", download=False, backbone=backbone,
                          lm_quant=quant)
        tm = model._model
        torch.cuda.synchronize()
        bb = tm.cfg.llm.backbone
        if quant is None:
            print(f"{name} phase: load(seed=0, backbone={backbone!r}) "
                  f"{time.perf_counter() - t0:.2f} s: {bb.num_layers} layers, hidden {bb.hidden_size}, head dim {bb.head_dim}, "
                  f"q/k norms {bb.use_qk_norm}, use_bistream {tm.use_bistream} [{card}]")
        _protocol_bias(tm.params["llm"], tm.cfg.llm)
        per = (7 * bb.num_layers, 7 * bb.num_layers + 1) if quant else None
        what = f"{name} {quant or 'bf16'} stream_text"
        runs.append(_bistream_request(tm, lambda: model.stream_text(_words(STREAM_TEXT), prompt),
                                      card, what, per))
        if quant is None and backbone is None:
            bis = TTSModel(cfg, tm.params, seed=0, compute_dtype=None, device="cuda",
                           use_bistream=True)
            inputs = model._frontend.frontend_zero_shot(STREAM_TEXT, prompt)
            runs.append(_bistream_request(bis, lambda: bis.tts(inputs), card,
                                          f"{name} bf16 TTSModel(use_bistream=True).tts"))
            del bis
        if quant:
            k2 += runs[-1]["k2"]
            k2_decodes += [(1, 64, 0, bb)] * runs[-1]["extends"] + [(1, 0, runs[-1]["steps"], bb)]
        del model, tm
        gc.collect()
        torch.cuda.empty_cache()
    return ([s for r in runs for s in r["shapes"]], sum(r["launches"] for r in runs),
            k2_decodes, k2)


def lm_train_path(card: str) -> None:
    """The speech LM's training at the published widths: the Qwen2-0.5B LM
    (``TTSConfig().llm``, random weights from seed 0) in fp32 with
    ``TrainConfig()``'s optimizer (adamw, accum_grad 4) through the
    trainer's LM step functions: 4 steps on B = 2 batches from
    ``build_lm_batch`` (text of 40-100 tokens, speech of 200-400,
    ``bistream_prob=0.5``: both layouts occur), a CV batch, 2 LoRA steps
    (rank 8) and 2 DPO steps.  Gates: finite losses and gradient norms, the
    LM's parameters unchanged after steps 1-3 and updated at step 4, both
    layouts seen; no kernel launched (the LM attends by plain einsum, as the
    JAX package).  Prints forward / backward / optimizer ms per step and
    peak memory."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.config import TrainConfig, TTSConfig
    from cosyvoice2_eu_torch.models.llm import init_lm
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.train.sequences import build_lm_batch
    from cosyvoice2_eu_torch.train.train import make_lm_step_fn
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_leaves
    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    dev = resolve_device("cuda")
    cfg = TTSConfig().llm
    tc = TrainConfig()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"LM training phase: init_lm(TTSConfig().llm, seed 0) on {dev}, {n_params / 1e6:.2f} M "
          f"parameters, fp32, {tc.optim} lr {tc.lr} accum_grad {tc.accum_grad}, "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    rng = np.random.default_rng(0)
    fill = cfg.speech_token_size + 2

    def batch(seed, rejected=False):
        r = np.random.default_rng(seed)
        texts = [r.integers(2, cfg.backbone.vocab_size, r.integers(40, 101)) for _ in range(2)]
        speeches = [r.integers(0, cfg.speech_token_size, r.integers(200, 401)) for _ in range(2)]
        coins = np.random.default_rng()
        coins.bit_generator.state = rng.bit_generator.state  # rejected rows: the same layouts
        b = build_lm_batch(texts, speeches, cfg, rng, bistream_prob=0.5, pad_to=600)
        if rejected:
            other = [r.integers(0, cfg.speech_token_size, len(s)) for s in speeches]
            b.update({f"reject_{k}": v for k, v in build_lm_batch(
                texts, other, cfg, coins, 0.5, pad_to=600).items()})
        layouts = ["bistream" if (row == fill).any() else "unistream" for row in b["target"]]
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}, layouts

    timer = StageTimer(sync=torch.cuda.synchronize)
    counters = _counters()
    _reset_counts()
    seen, records = set(), []
    for mode, n_steps in (("lm", 4), ("lora", 2), ("dpo", 2)):
        tx = make_optimizer(tc)
        trained, step_fn, cv_fn = make_lm_step_fn(
            cfg, tc, tx, params, dpo=mode == "dpo", lora=mode == "lora", lora_rank=8,
            gen=torch.Generator(device=dev).manual_seed(1), timer=timer)
        state = init_train_state(trained, tx)
        initial = [x.clone() for x in tree_leaves(trained)] if mode == "lm" else None
        for i in range(n_steps):
            b, layouts = batch(len(records), rejected=mode == "dpo")
            seen.update(layouts)
            timer.reset()
            _reset_peak()
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = timer.summary()
            rec = dict(mode=mode, step=state.step, loss=loss, grad_norm=grad_norm, ms=wall * 1e3,
                       tokens=int(b["lengths"].sum()), peak=torch.cuda.max_memory_allocated(),
                       **{k: st[k]["total_s"] * 1e3 for k in ("forward", "backward", "optimizer")})
            if initial is not None:
                rec["unchanged"] = all(torch.equal(a, x) for a, x in
                                       zip(tree_leaves(state.params), initial))
            records.append(rec)
            print(f"LM train {mode} step {rec['step']}: B=2 rows {layouts}, {rec['tokens']} "
                  f"tokens (each row padded to 600), loss {loss:.4f} grad_norm {grad_norm:.4f}; "
                  f"{rec['ms']:.1f} ms (forward {rec['forward']:.1f}, backward "
                  f"{rec['backward']:.1f}, optimizer {rec['optimizer']:.1f}), "
                  f"{rec['tokens'] / wall:.0f} tokens/s, peak {rec['peak'] / 2**30:.2f} GiB"
                  + ("" if initial is None else
                     f"; parameters {'unchanged' if rec['unchanged'] else 'updated'}")
                  + f" [{card}]")
        if mode == "lm":
            with torch.no_grad():
                cv = cv_fn(state.params, batch(99)[0])
            print(f"LM train CV: loss {float(cv['loss']):.4f} acc {float(cv['acc']):.4f} [{card}]")
            records.append(dict(mode="cv", loss=float(cv["loss"]), grad_norm=1.0))
        del state, trained, step_fn, cv_fn, tx
        gc.collect()
        torch.cuda.empty_cache()
    launches = [f.launches for f in counters]
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                 for r in records)
    multisteps = [r["unchanged"] for r in records if "unchanged" in r] == [True] * 3 + [False]
    ok = finite and multisteps and seen == {"unistream", "bistream"} and not any(launches)
    print(f"LM training phase: losses and gradient norms finite: {finite}; parameters unchanged "
          f"after steps 1-3 and updated at step 4 (MultiSteps): {multisteps}; layouts seen "
          f"{sorted(seen)}; K1/K3/K4/K2 launches {launches}; peak memory "
          f"{max(r.get('peak', 0) for r in records) / 2**30:.2f} GiB [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the LM training phase failed its checks")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 6c. GAN training; 6d. the trainer's data path and command line
# ---------------------------------------------------------------------------

def _stage_timer():
    """A ``StageTimer`` that syncs the card at each stage's end and also
    keeps, per stage, its wall ms and the launches of K1, K3, K4 and K2 in it."""
    import contextlib

    import torch

    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    class Recording(StageTimer):
        def __init__(self):
            super().__init__(sync=torch.cuda.synchronize)
            self.records = []

        @contextlib.contextmanager
        def stage(self, name):
            before = [f.launches for f in _counters()]
            t0 = time.perf_counter()
            with super().stage(name):
                yield
            self.records.append((name, (time.perf_counter() - t0) * 1e3,
                                 [f.launches - n for f, n in zip(_counters(), before)]))

        def ms(self, name) -> list:
            return [ms for n, ms, _ in self.records if n == name]

        def launched(self, name) -> list:
            return [lc for n, _, lc in self.records if n == name]

    return Recording()


def _harmonic(rng, seconds: float, f0_base: float, vibrato: float, rate: float,
              sr: int = 24000):
    """A seeded harmonic signal (4 partials, 1/k amplitudes, light noise) whose
    F0 is ``f0_base`` with a sine vibrato of ``vibrato`` Hz at ``rate`` Hz."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    f0 = f0_base + vibrato * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3, 4))
    return (sig + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


# GAN phase: 3 batches of 58 crops (dynamic_batch's 3000 frames / 51 a crop)
GAN_SAMPLES, GAN_BATCHES = 174, 3


def _gan_samples(n: int, seed: int = 0) -> tuple[list, dict]:
    """In-memory 24 kHz samples of 3-8 s for the GAN pipeline: each a
    harmonic signal whose F0 is a base of 90-260 Hz with a 5 Hz vibrato of
    +-3 Hz (so the median F0 over any 1 s crop is the base within 0.1 Hz).
    Returns the samples and each one's base F0 by ``utt``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    samples, base = [], {}
    for i in range(n):
        f0 = float(rng.uniform(90.0, 260.0))
        samples.append({"utt": f"gan{i}", "text": "Bonjour.", "sample_rate": 24000,
                        "speech": _harmonic(rng, float(rng.uniform(3.0, 8.0)), f0, 3.0, 5.0)})
        base[f"gan{i}"] = f0
    return samples, base


@_uncounted
def check_small_gan_reference() -> None:
    """One discriminator turn and one generator turn (``make_gan_steps``) on
    the card against the CPU plain path: the tiny HiFT with the full-width
    discriminators, 2 crops of hop x 8 samples, the same weights, batch and
    sine-source draws, TF32 off; both turns at the initial parameters.
    Every loss within 1e-5 relative; every gradient leaf, read from Adam's
    first moment (0.1 x the gradient clipped to norm 5), within 1e-4 x max
    + 1e-8 (1e-7 on the gradient)."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.config import tiny_test_config
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.train.gan import init_discriminator, make_gan_draws
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.train.train_gan import GAN_TRAIN_CONFIG, make_gan_steps
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map

    resolve_device("cuda")  # fp32 stays fp32: no TF32
    cfg = tiny_test_config()
    gen = init_hift(torch.Generator().manual_seed(0), cfg.hift)
    disc = init_discriminator(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    n = cfg.mel.hop_size * 8
    batch = {"speech": torch.tensor(rng.standard_normal((2, n)) * 0.1, dtype=torch.float32),
             "speech_feat": torch.tensor(rng.standard_normal((2, 8, cfg.hift.in_channels)),
                                         dtype=torch.float32),
             "pitch_feat": torch.tensor(np.abs(rng.standard_normal((2, 8))) * 200,
                                        dtype=torch.float32)}
    draws = make_gan_draws(torch.Generator().manual_seed(2), batch, cfg.hift)
    out = {}
    for dev in ("cpu", "cuda"):
        tx = make_optimizer(GAN_TRAIN_CONFIG)
        gen_step, disc_step = make_gan_steps(cfg, tx, tx)
        g, d, b = (tree_map(lambda x: x.to(dev), tree) for tree in (gen, disc, batch))
        dr = tuple(x.to(dev) for x in draws)
        _, opt_d, m_d = disc_step(d, tx.init(d), g, b, dr)
        _, opt_g, m_g = gen_step(g, tx.init(g), d, b, dr)
        losses = {**{f"disc {k}": float(v) for k, v in m_d.items()},
                  **{f"gen {k}": float(v) for k, v in m_g.items()}}
        out[dev] = losses, [x.cpu() for x in tree_leaves((opt_d["mu"], opt_g["mu"]))]
    (l_cpu, mu_cpu), (l_gpu, mu_gpu) = out["cpu"], out["cuda"]
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30) for k in l_cpu}
    errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(mu_gpu, mu_cpu)]
    worst = max(err / (1e-4 * peak + 1e-8) for err, peak in errs)
    ok = all(math.isfinite(v) for v in l_gpu.values()) and max(loss_errs.values()) <= 1e-5 \
        and worst <= 1.0
    print(f"GAN reference check (tiny HiFT, full-width discriminators, 2 crops of {n} samples, "
          f"fp32, card vs CPU plain path): losses "
          + ", ".join(f"{k} {l_gpu[k]:.6f} (rel err {loss_errs[k]:.2e})" for k in l_cpu)
          + f", tol 1e-5; {len(errs)} gradient leaves of both turns, each within 1e-4 x max + "
          f"1e-8 of Adam's first moment: the worst at {worst:.3f} of its tolerance "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the card's GAN turns disagree with the plain CPU path")


def gan_path(card: str) -> None:
    """HiFT GAN training at the published widths (``HiFTConfig()``, base 512
    channels, and both discriminators): ``GAN_SAMPLES`` in-memory samples
    through the port's pipeline with ``gan=True`` (24480-sample crops, the
    host mel at fmax 8 kHz, the native YIN, ``dynamic_batch`` at 3000
    frames), ``GAN_BATCHES`` batches through ``train_gan.train_gan`` (a
    discriminator turn, then a generator turn, each; the epoch's
    checkpoint).  Gates: finite losses and no skipped (non-finite) update,
    both parameter trees moved, every crop's median voiced YIN F0 within 5
    Hz of its signal's, no kernel launched.  Prints the batch size, each
    turn's ms, the host featurize ms per crop (mel and YIN apart), the
    pipeline's ms and peak memory."""
    import itertools
    import random

    import numpy as np
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.train import dataset as ds
    from cosyvoice2_eu_torch.train.gan import init_discriminator
    from cosyvoice2_eu_torch.train.pitch import estimate_f0
    from cosyvoice2_eu_torch.train.train_gan import gan_mel_fn, train_gan
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    dev = resolve_device("cuda")
    cfg = TTSConfig()
    t0 = time.perf_counter()
    samples, base = _gan_samples(GAN_SAMPLES)
    make_s = time.perf_counter() - t0
    mel_fn = gan_mel_fn(cfg)
    seen, pipe_s = [], [0.0]

    def batches(epoch):
        it = ds.samples_pipeline(samples, get_tokenizer(""), mel_fn, gan=True,
                                 rng=random.Random(epoch))
        for _ in range(GAN_BATCHES):
            t0 = time.perf_counter()
            b = next(it)
            pipe_s[0] += time.perf_counter() - t0
            seen.append(b)
            yield b
        it.close()

    seed = 0
    timer = _stage_timer()
    _reset_counts()
    _reset_peak()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        out = train_gan(cfg, batches, model_dir, 1, seed, dev, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        saved = os.path.exists(os.path.join(model_dir, "epoch_0_whole"))
    launches = [f.launches for f in _counters()]
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen0 = init_hift(torch.Generator(device=dev).manual_seed(seed), cfg.hift)
    disc0 = init_discriminator(torch.Generator(device=dev).manual_seed(seed + 1))
    moved = [any(not torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(old)))
             for new, old in ((out["generator"], gen0), (out["discriminator"], disc0))]
    n_params = [sum(x.numel() for x in tree_leaves(t)) for t in (gen0, disc0)]
    del gen0, disc0
    m_d, m_g = out["metrics"]
    losses = {**{f"disc {k}": float(v) for k, v in m_d.items()},
              **{f"gen {k}": float(v) for k, v in m_g.items()}}
    skipped = out["opt_g"]["total_notfinite"] + out["opt_d"]["total_notfinite"]
    f0_errs = []
    for b in seen:
        for utt, p in zip(b["utts"], b["pitch_feat"]):
            v = p[p > 0]
            f0_errs.append(abs(float(np.median(v)) - base[utt]) if len(v) else float("inf"))
    # the host featurizers on a crop each, timed apart
    crops = [s["speech"][:24480] for s in itertools.islice(samples, 20)]
    t0 = time.perf_counter()
    for c in crops:
        mel_fn(c)
    mel_ms = (time.perf_counter() - t0) * 1e3 / len(crops)
    t0 = time.perf_counter()
    for c in crops:
        estimate_f0(c)
    yin_ms = (time.perf_counter() - t0) * 1e3 / len(crops)
    sizes = [len(b["utts"]) for b in seen]
    disc_ms, gen_ms = timer.ms("disc_turn"), timer.ms("gen_turn")
    print(f"GAN phase: HiFTConfig() ({n_params[0] / 1e6:.2f} M parameters) and the MPD + MRD "
          f"discriminators ({n_params[1] / 1e6:.2f} M), fp32, adam 2e-4, clip 5; {GAN_SAMPLES} "
          f"samples of 3-8 s made in {make_s:.2f} s; batches of {sizes} crops x "
          f"{seen[0]['speech'].shape[1]} samples ({seen[0]['speech_feat'].shape[1]} mel frames) "
          f"[{card}]")
    for i, (d_ms, g_ms) in enumerate(zip(disc_ms, gen_ms)):
        print(f"GAN step {i + 1}: B={sizes[i]}, discriminator turn {d_ms:.1f} ms, generator turn "
              f"{g_ms:.1f} ms [{card}]")
    ok = (all(math.isfinite(v) for v in losses.values()) and skipped == 0 and all(moved)
          and saved and out["steps"] == GAN_BATCHES and not any(launches)
          and max(f0_errs) <= 5.0)
    print(f"GAN phase: {out['steps']} steps in {wall:.2f} s (pipeline {pipe_s[0] * 1e3:.0f} ms "
          f"for the {len(seen)} batches, {pipe_s[0] * 1e3 / len(seen):.1f} ms a batch); host "
          f"featurize per crop: mel {mel_ms:.2f} ms, YIN {yin_ms:.2f} ms; last losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
          + f"; skipped updates {skipped}; generator and discriminator moved {moved}; "
          f"checkpoint saved {saved}; YIN median voiced F0 per crop within "
          f"{max(f0_errs):.3f} Hz of the signal's (median {float(np.median(f0_errs)):.3f} Hz, "
          f"gate 5 Hz) over {len(f0_errs)} crops; K1/K3/K4/K2 launches {launches}; peak memory "
          f"{peak:.2f} GiB [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the GAN phase failed its checks")
    del out
    gc.collect()
    torch.cuda.empty_cache()


CLI_TEXTS = ("Bonjour tout le monde, il fait beau aujourd'hui.",
             "Le chat dort sur le canapé depuis ce matin.",
             "Nous partirons à Paris la semaine prochaine.",
             "Elle lit un livre au bord de la mer.")
# (samples, seed): the flow's training samples make 4 batches at 3000 frames (9 x
# 326, 6 x 440, 5 x 496, 5 x 556 mel frames), the CV samples 1 (4 x 404), the
# LM's 2 (6 x 486, 4 x 542)
CLI_FLOW, CLI_CV, CLI_LM = (25, 0), (4, 1), (10, 0)


def _cli_samples(n: int, seed: int) -> list:
    """In-memory 24 kHz samples of 4-12 s as the parquet holds them: French
    text, a harmonic signal, random speech tokens at 25 Hz (the LM's and
    the flow's 6561 codes), 192-d utterance and speaker embeddings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seconds = float(rng.uniform(4.0, 12.0))
        out.append({"utt": f"cli{seed}_{i}", "text": CLI_TEXTS[i % len(CLI_TEXTS)],
                    "sample_rate": 24000,
                    "speech": _harmonic(rng, seconds, float(rng.uniform(90, 250)), 10.0, 0.7),
                    "speech_token": rng.integers(0, 6561, int(seconds * 25)).astype(np.int32),
                    "utt_embedding": rng.standard_normal(192).astype(np.float32),
                    "spk_embedding": rng.standard_normal(192).astype(np.float32)})
    return out


def cli_path(card: str) -> tuple[list, int, list]:
    """The trainer's command line from the batch iterators down to the
    checkpoint: ``train.run`` (the split-out body of ``train.main``) on
    in-memory samples through the pipeline after the opener, ``prefetch``
    on: ``--model flow`` at ``TTSConfig().flow`` for one epoch (4 steps,
    accum_grad 4: one emitting step; CV; the epoch's checkpoint), then
    ``--resume`` to a second epoch, then ``--model llm`` (the Qwen2-0.5B LM,
    fp32) for 2 steps.  Each run's counts are set to 0 before it and read
    after.  Gates: finite losses (the last step's, CV's, and no update
    skipped as non-finite), the steps and the emitting steps, the resume
    continuing at epoch 1 and step 4, a beat of ``StragglerGuard`` a step;
    flow: K1 (with LSE), K3 and K4 56 launches each a step, K1 56 a CV
    batch, every launch on its fp32 design; LM: no launch.  Prints the
    pipeline's ms a batch beside the step's, and peak memory.  Returns the
    flow's step records (lengths, chunk), K1's launches over the flow runs
    and their CV batches' lengths."""
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.ops import flash_attention as fa
    from cosyvoice2_eu_torch.train import train as T
    from cosyvoice2_eu_torch.train.executor import list_checkpoints
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    est = TTSConfig().flow.estimator
    per_step = (2 + est.num_mid_blocks) * est.n_blocks
    data = {"flow_train": _cli_samples(*CLI_FLOW), "cv": _cli_samples(*CLI_CV),
            "lm_train": _cli_samples(*CLI_LM)}

    def open_samples(name, epoch):
        return (dict(s) for s in data[name])  # each pass on fresh dicts: the stages write them

    # record each flow step's and CV batch's lengths and chunk, for K1/K3/K4's
    # checks and timings at this path's shapes
    steps, cv_lens = [], []
    make_step, make_cv = T.make_flow_step_fn, T.make_flow_cv_fn

    def recording_step_fn(raw_step, cfg, gen, rng):
        def traced(state, batch, draws, streaming=False):
            steps.append({"lens": batch["speech_feat_len"].tolist(),
                          "chunk": cfg.estimator.static_chunk_size if streaming else 0})
            return raw_step(state, batch, draws, streaming=streaming)

        return make_step(traced, cfg, gen, rng)

    def recording_cv_fn(cfg):
        cv_fn = make_cv(cfg)

        def traced(params, batch):
            cv_lens.append(batch["speech_feat_len"].tolist())
            return cv_fn(params, batch)

        return traced

    runs, ok, k1_flow = {}, True, 0
    T.make_flow_step_fn, T.make_flow_cv_fn = recording_step_fn, recording_cv_fn
    try:
        with tempfile.TemporaryDirectory() as root:
            for name, model, extra in (("flow", "flow", ["--max_epoch", "1"]),
                                       ("flow --resume", "flow", ["--max_epoch", "2", "--resume"]),
                                       ("llm", "llm", ["--max_epoch", "1"])):
                train_list = "lm_train" if model == "llm" else "flow_train"
                args = T.parse_args(["--model", model, "--train_data", train_list, "--cv_data",
                                     "cv", "--model_dir", os.path.join(root, model), "--seed",
                                     "0", "--device", "cuda"] + extra)
                timer = _stage_timer()
                _reset_counts()
                _reset_peak()
                t0 = time.perf_counter()
                out = T.run(args, open_samples, timer)
                wall = time.perf_counter() - t0
                launches = [f.launches for f in _counters()]
                state, ex = out["state"], out["executor"]
                infos = {i["tag"]: i for i in list_checkpoints(args.model_dir)}
                last = {k: float(v) for k, v in out["metrics"].items()}
                opt = state.opt_state
                n_steps = len(timer.ms("step"))
                want_steps = 2 if model == "llm" else 4
                first_step = 4 if name == "flow --resume" else 0
                epoch_tag = "epoch_1_whole" if name == "flow --resume" else "epoch_0_whole"
                finite = (all(math.isfinite(v) for v in last.values())
                          and math.isfinite(infos[epoch_tag]["cv_loss"])
                          and opt["total_notfinite"] == 0
                          and all(bool(torch.isfinite(x).all()) for x in tree_leaves(state.params)))
                counts_ok = (n_steps == want_steps and ex.step == first_step + want_steps
                             and infos[epoch_tag]["step"] == ex.step
                             and opt["gradient_step"] * 4 + opt["mini_step"] == ex.step
                             and out["beats"] == n_steps)
                if model == "flow":
                    k1_flow += launches[0]
                    kernels_ok = (all(lc == [per_step] * 3 + [0] for lc in timer.launched("step"))
                                  and all(lc == [per_step, 0, 0, 0]
                                          for lc in timer.launched("cv_step"))
                                  and fa.fwd_kernel(torch.float32) in LAUNCHED
                                  and fa.fwd_kernel(torch.bfloat16) not in LAUNCHED)
                else:
                    kernels_ok = not any(launches)
                batch_ms = sum(timer.ms("batch")) / max(n_steps, 1)
                step_ms = timer.ms("step")
                runs[name] = dict(ok=finite and counts_ok and kernels_ok)
                ok = ok and runs[name]["ok"]
                print(f"trainer CLI {name}: train.run(--model {model} {' '.join(extra)}): "
                      f"{n_steps} steps (executor step {ex.step}, emitting steps "
                      f"{opt['gradient_step']}), {len(timer.ms('cv_step'))} CV batches, "
                      f"{wall:.2f} s; pipeline {batch_ms:.1f} ms a batch beside steps of "
                      + ", ".join(f"{ms:.1f}" for ms in step_ms)
                      + f" ms; last step loss {last['loss']:.4f}, cv_loss "
                      f"{infos[epoch_tag]['cv_loss']:.4f}, skipped updates "
                      f"{opt['total_notfinite']}; checkpoints {sorted(infos)}; StragglerGuard "
                      f"beats {out['beats']}; K1/K3/K4/K2 launches {launches}"
                      + (f" (per step {timer.launched('step')}, per CV batch "
                         f"{timer.launched('cv_step')}; designs called {sorted(LAUNCHED)})"
                         if model == "flow" else "")
                      + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                      f"[{card}] {'ok' if runs[name]['ok'] else 'FAIL'}")
                del out, state, ex
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        T.make_flow_step_fn, T.make_flow_cv_fn = make_step, make_cv
    if not ok:
        raise SystemExit("the trainer's command-line phase failed its checks")
    return steps, k1_flow, cv_lens


# ---------------------------------------------------------------------------
# the v1 family (CosyVoice-300M): fp32 end to end, so K1's fp32 design
# ---------------------------------------------------------------------------

# 15 bytes each: the LM stops at 20 x 15 = 300 tokens, ~6 s of speech
V1_TEXTS = ("Bonjour, Paris.", "Hello, London!!")


class _V1Draws:
    """The v1 model's random draws made on the CPU from ``seed``, the same on
    every device: the LM's Gumbel vectors by step, the flow's noise and
    HiFT's draws by call (``reset`` starts the calls over)."""

    def __init__(self, cfg, seed: int):
        self.cfg, self.seed = cfg, seed
        self.reset()

    def reset(self) -> None:
        self.calls = 0

    def _gen(self):
        import torch

        self.calls += 1
        return torch.Generator().manual_seed(1000 * self.seed + self.calls)

    def lm(self, device):
        import torch

        from cosyvoice2_eu_torch.ops.sampling import gumbel

        gen, made = torch.Generator().manual_seed(self.seed), []

        def draws(step):
            while len(made) <= step:
                made.append((gumbel((1, self.cfg.llm.top_k), gen),
                             gumbel((1, self.cfg.llm.speech_token_size + 1), gen)))
            return tuple(x.to(device) for x in made[step])

        return draws

    def flow_noise(self, shape):
        import torch

        return torch.randn(shape, generator=self._gen())

    def hift_draws(self, batch, length, harmonics):
        import torch

        gen = self._gen()
        return (torch.rand((batch, harmonics), generator=gen),
                torch.randn((batch, length, harmonics), generator=gen))


def _small_v1_config():
    """A tiny TTSV1Config with the v1 geometry (5 Hz tokens, a 32-sample hop,
    HiFT 4 x 2 x 4) and an estimator with K1's head dim of 64."""
    from cosyvoice2_eu_torch import config as c

    mels = 8
    text_enc = c.GenericEncoderConfig(
        input_size=12, output_size=24, attention_heads=2, linear_units=32, num_blocks=1,
        input_layer="linear", use_cnn_module=False, macaron_style=False, static_chunk_size=1,
        max_len=512)
    llm_enc = c.GenericEncoderConfig(
        input_size=24, output_size=24, attention_heads=2, linear_units=32, num_blocks=2,
        arch="transformer", input_layer="linear_legacy", activation_type="relu",
        static_chunk_size=1, max_len=512)
    llm = c.LMV1Config(text_encoder_input_size=12, llm_input_size=24, llm_output_size=24,
                       text_token_size=40, speech_token_size=16, spk_embed_dim=10,
                       text_encoder=text_enc, llm=llm_enc, top_k=8)
    flow = c.FlowV1Config(
        input_size=16, output_size=mels, spk_embed_dim=10, vocab_size=32, input_frame_rate=5,
        sample_rate=320, mel_hop=32, cache_tail_tokens=4,
        encoder=c.GenericEncoderConfig(
            input_size=16, output_size=16, attention_heads=2, linear_units=32, num_blocks=1,
            input_layer="linear", use_cnn_module=False, macaron_style=False, max_len=512),
        length_regulator=c.LengthRegulatorConfig(channels=mels, sampling_ratios=(1, 1)),
        estimator=c.EstimatorV1Config(in_channels=4 * mels, out_channels=mels,
                                      channels=(16, 16), attention_head_dim=64, n_blocks=1,
                                      num_mid_blocks=2, num_heads=2),
        cfm=c.CFMConfig(n_timesteps=2))
    hift = c.HiFTConfig(
        in_channels=mels, base_channels=32, nb_harmonics=2, sampling_rate=320,
        upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), source_resblock_kernel_sizes=(7, 11),
        source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
        f0_predictor=c.F0PredictorConfig(in_channels=mels, cond_channels=32))
    return c.TTSV1Config(
        llm=llm, flow=flow, hift=hift, token_overlap_len=4, mel_cache_len=3,
        mel=c.MelConfig(n_fft=64, num_mels=mels, sampling_rate=320, hop_size=32, win_size=64),
        frontend=c.FrontendConfig(target_sr=320, spk_embed_dim=10))


def _k1_per_v1_flow(cfg) -> int:
    """K1 launches of one v1 flow call: each transformer block of the
    estimator, each Euler step (640 at the published widths)."""
    from cosyvoice2_eu_torch.models.estimator_v1 import k1_launches_per_call

    return k1_launches_per_call(cfg.flow.estimator) * cfg.flow.cfm.n_timesteps


def check_small_v1() -> None:
    """The v1 model on the card (fp32, K1's fp32 design) against the plain
    CPU path on a small config with the same weights and draws: equal
    ``lm_decode`` tokens, ``tts(stream=False)`` audio within 1e-3, and a
    streamed ``vc`` in chunks equal in count and length, within 1e-3."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.models.flow_v1 import init_flow_v1, mel_len_for_tokens
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm_v1 import init_lm_v1
    from cosyvoice2_eu_torch.ops import flash_attention as fa

    cfg = _small_v1_config()
    gen = torch.Generator().manual_seed(1)
    params = {"llm": init_lm_v1(gen, cfg.llm), "flow": init_flow_v1(gen, cfg.flow),
              "hift": init_hift(gen, cfg.hift)}
    rng = np.random.default_rng(4)
    text = rng.integers(1, cfg.llm.text_token_size, 6).astype(np.int32)
    ptext = rng.integers(1, cfg.llm.text_token_size, 2).astype(np.int32)
    psp = rng.integers(0, cfg.llm.speech_token_size, 5).astype(np.int32)
    feat = rng.standard_normal((mel_len_for_tokens(cfg.flow, 5), cfg.flow.output_size)) \
        .astype(np.float32)
    emb = rng.standard_normal(cfg.llm.spk_embed_dim).astype(np.float32)
    source = rng.integers(0, cfg.llm.speech_token_size, 34).astype(np.int32)
    out = []
    for dev in ("cpu", "cuda"):
        model, _, _ = cosy.load_v1(config=cfg, params=params, device=dev)
        draws = _V1Draws(cfg, 5)
        _reset_counts()
        tokens = model.lm_decode(text, ptext, psp, emb, max_gen=24, lm_draws=draws.lm(dev))
        kw = dict(flow_noise=draws.flow_noise, hift_draws=draws.hift_draws)
        wav = next(model.tts(text, ptext, psp, feat, emb, max_gen=24, lm_draws=draws.lm(dev), **kw))
        chunks = list(model.vc(source, psp, feat, emb, stream=True, **kw))
        out.append((tokens, wav, chunks, fa.flash_attention.launches, draws.calls // 2))
    (tok_c, wav_c, ch_c, _, _), (tok_g, wav_g, ch_g, k1, flows) = out
    same = np.array_equal(tok_c, tok_g) and len(ch_c) == len(ch_g) and all(
        a.shape == b.shape for a, b in zip(ch_c, ch_g))
    err = max([float(np.abs(wav_c - wav_g).max())] + [float(np.abs(a - b).max())
                                                      for a, b in zip(ch_c, ch_g)]) \
        if same and wav_c.shape == wav_g.shape else float("inf")
    want_k1 = _k1_per_v1_flow(cfg) * flows
    design = _k1_design(torch.float32)
    ok = same and err <= 1e-3 and k1 == want_k1 and all(
        np.isfinite(c).all() for c in [wav_g] + ch_g)
    print(f"v1 reference check (small config, fp32, card vs CPU plain path): lm_decode tokens "
          f"{len(tok_g)} equal: {np.array_equal(tok_c, tok_g)}; tts and a streamed vc of "
          f"{len(source)} tokens in {len(ch_g)} chunks (lengths {[len(c) for c in ch_g]}), "
          f"audio max_abs_err={err:.3e} (tol 1e-3); K1 launches {k1} (expected {want_k1} = "
          f"{_k1_per_v1_flow(cfg)} x {flows} flow calls; {design}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the card's v1 model disagrees with the plain CPU path")


def _v1_prompt(cfg, seconds: float, seed: int = 0) -> tuple:
    """(speech tokens at 50 Hz, the 22.05 kHz prompt mel, the x-vector) of a
    synthetic prompt of ``seconds``."""
    import numpy as np

    from cosyvoice2_eu_torch.models.flow_v1 import mel_len_for_tokens

    rng = np.random.default_rng(seed)
    n_sp = int(seconds * cfg.flow.input_frame_rate)
    feat = rng.standard_normal((mel_len_for_tokens(cfg.flow, n_sp), cfg.flow.output_size))
    return (rng.integers(0, cfg.llm.speech_token_size, n_sp).astype(np.int32),
            (feat * 0.5 - 4.0).astype(np.float32),
            rng.standard_normal(cfg.llm.spk_embed_dim).astype(np.float32))


def v1_path(card: str) -> tuple[list, int]:
    """``load_v1(config=TTSV1Config(), seed=0, device="cuda")`` at
    CosyVoice-300M's published widths (random weights): 1 request, 1
    streamed request and a ``vc`` of the first request's tokens, from a
    synthetic 3 s prompt, each with the counts set to 0 before it and read
    after it.  Gates: finite, non-silent audio of mel frames x 256 samples,
    K1 640 times a flow call, every launch on its fp32 design.  Prints LM
    ms/token, flow ms a call, HiFT ms, RTF, the first chunk's latency and
    peak memory.  Returns each flow call's mel length T and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSV1Config
    from cosyvoice2_eu_torch.models.flow_v1 import mel_len_for_tokens
    from cosyvoice2_eu_torch.ops import flash_attention as fa

    cfg = TTSV1Config()
    per_call = _k1_per_v1_flow(cfg)
    t0 = time.perf_counter()
    model, frontend, _ = cosy.load_v1(config=cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for group in ("llm", "flow", "hift")
                   for x in _by_path(model.params[group]).values())
    print(f"v1 path: load_v1(TTSV1Config(), seed=0, device='cuda') {time.perf_counter() - t0:.2f} "
          f"s, {n_params / 1e6:.2f} M parameters [{card}]")
    psp, feat, emb = _v1_prompt(cfg, 3.0)
    calls = []  # (mel length T, the call's tokens) of each flow call
    inner = model.token2wav

    def recorded(token, prompt_token, prompt_feat, *args, **kwargs):
        calls.append((prompt_feat.shape[0] + mel_len_for_tokens(cfg.flow, len(token)),
                      np.asarray(token).copy()))
        return inner(token, prompt_token, prompt_feat, *args, **kwargs)

    model.token2wav = recorded
    empty = np.zeros(0, np.int32)
    requests = [("tts", V1_TEXTS[0], False), ("tts", V1_TEXTS[1], True), ("vc", None, False)]
    launches, source = 0, None
    for i, (kind, text, stream) in enumerate(requests):
        _reset_peak()
        _reset_counts()
        model.timer.reset()
        first = len(calls)
        t0 = time.perf_counter()
        if kind == "tts":
            chunks = model.tts(frontend.text_tokens(text), empty, psp, feat, emb, stream=stream)
            n_tok = model.last_n_tokens
        else:
            chunks, n_tok = model.vc(source, psp, feat, emb), len(source)
        walls, lens = [], []
        for chunk in chunks:
            walls.append((time.perf_counter() - t0) * 1e3)
            lens.append(len(chunk))
            ok_chunk = np.isfinite(chunk).all() and float(np.abs(chunk).max()) > 1e-3
            if not ok_chunk:
                raise SystemExit(f"v1 request {i}: a chunk is not finite or silent")
        wall = time.perf_counter() - t0
        flows = len(calls) - first
        if source is None:
            source = calls[first][1]
        k1 = fa.flash_attention.launches
        design = _k1_design(torch.float32)
        samples = sum(lens)
        want = mel_len_for_tokens(cfg.flow, n_tok) * cfg.hift.upsample_scale
        stages = model.timer.summary()
        audio_s = samples / cfg.sample_rate
        ok = (samples == want and k1 == per_call * flows and not any(
            f.launches for f in _counters()[1:]))
        lm = (f"LM {stages['lm_decode']['total_s'] * 1e3 / max(n_tok, 1):.2f} ms/token, "
              if kind == "tts" else "")
        print(f"v1 request {i} ({kind}, stream={stream}): "
              + (f"{len(text.encode())} text bytes -> " if text else "")
              + f"{n_tok} tokens, {audio_s:.2f} s audio ({samples} samples, expected {want}) in "
              f"{len(lens)} chunks at T {[c[0] for c in calls[first:]]}; {lm}flow "
              f"{stages['flow']['total_s'] * 1e3 / flows:.1f} ms a call x {flows}, HiFT "
              f"{stages['hift']['total_s'] * 1e3:.1f} ms, wall {wall:.2f} s, RTF "
              f"{wall / audio_s:.3f}, first chunk after {walls[0]:.1f} ms; K1 launches {k1} "
              f"(expected {per_call} x {flows}; {design}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}] "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"v1 request {i} failed its checks")
        launches += k1
    ts = [c[0] for c in calls]
    del model, frontend, calls
    gc.collect()
    torch.cuda.empty_cache()
    return ts, launches


@_uncounted
def time_v1_flash_attention(flow_ts: list, card: str) -> dict:
    """K1's fp32 design at the v1 estimator's shapes, (2, 8, T, 64) and
    (2, 8, ceil(T / 2), 64) at chunk 0 without LSE for each flow call's T,
    as CUDA-graph replay, beside the plain version, SDPA and the 3xTF32
    bound; the mean per launch weighted as a flow call launches them (80
    at T, 560 at ceil(T / 2) at the published widths)."""
    import torch

    from cosyvoice2_eu_torch.config import TTSV1Config

    cfg = TTSV1Config()
    est = cfg.flow.estimator
    if len(est.channels) != 2:
        raise SystemExit("the v1 launch split assumes two U-Net resolutions")
    full = 2 * est.n_blocks * cfg.flow.cfm.n_timesteps  # the first down and the last up stage
    half = _k1_per_v1_flow(cfg) - full
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    timed, parts = {}, []
    for t_mel in flow_ts:
        for t_len, n in ((t_mel, full), ((t_mel + 1) // 2, half)):
            if t_len not in timed:
                r = timed[t_len] = _time_k1([t_len, t_len], t_len, 0, torch.float32, False, gen)
                print(f"K1 timing (v1) T={t_len} fp32 chunk=0 B=2 [{card}]: kernel "
                      f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, {100 * r['share']:.1f}% of "
                      f"the 3xTF32 bound; eager from Python {r['eager_ms']:.4f} ms), plain "
                      f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms'] * 1e3:.2f} us, FMA bound {r['fma_bound_ms'] * 1e3:.2f} us "
                      f"({r['gflop']:.2f} GFLOP, {r['mb']:.2f} MB); output vs plain max_abs_err "
                      f"{r['err']:.3e} ok")
            parts.append((n, timed[t_len]))
    return _weighted(parts)


# ---------------------------------------------------------------------------
# several processes: data parallelism, sharded optimizer state, tensor-
# parallel decode (parallel_path); the evaluation harness (eval_path)
# ---------------------------------------------------------------------------

# the tp phase's decodes: fp32 tokens held to tp=1's, and the steps of each
# timed bf16 / int8 decode
TP_TOKENS, TP_TIMED = 16, 8
# (b)'s and (c)'s ranks share the one card over gloo (NCCL takes one rank a GPU)
PARALLEL_WORLD = 2


def _rank_entry(job: str, rank: int, world: int, init_file: str, out_file: str) -> None:
    """A spawned rank: joins the gloo group on the one card, runs ``job``
    (``_rank_dp`` or ``_rank_tp``) and saves its result; prints nothing."""
    import traceback

    import torch

    sys.path.insert(0, REPO)
    try:
        import torch.distributed as dist

        from cosyvoice2_eu_torch.ops import int8_matmul as i8

        torch.cuda.set_device(0)
        _record_k2_launches(i8)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            out = {"dp": _rank_dp, "tp": _rank_tp, "tp_serve": _rank_tp_serve}[job](rank, world)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": out}, out_file)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out_file)
        raise


def _run_ranks(job: str, world: int, timeout: float) -> list:
    """``world`` spawned ranks of ``job`` on the one card (the kernels are
    built already: the ranks load the libraries); every rank's result.  A
    rank that fails, or that does not finish in ``timeout`` s, ends the run;
    every process is stopped before this returns."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix=f"cosy_{job}_") as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_entry,
                             args=(job, r, world, os.path.join(d, "rendezvous"), outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if hung:
            raise SystemExit(f"parallel {job}: ranks {hung} did not finish in {timeout:.0f} s")
        results = []
        for r, path in enumerate(outs):
            res = torch.load(path, weights_only=False) if os.path.exists(path) else {
                "error": f"exit code {procs[r].exitcode}, no result"}
            if "error" in res:
                raise SystemExit(f"parallel {job}: rank {r} failed:\n{res['error']}")
            results.append(res["ok"])
    return results


def _tree_err(got, want) -> float:
    """The worst leaf's max|got - want| as a share of 1e-4 x max|want| + 1e-7."""
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    return max(((a.float() - b.float()).abs().max().item()
                / (1e-4 * b.float().abs().max().item() + 1e-7))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _flow_dp_inputs():
    """``TTSConfig().flow``'s parameters (seed 0), ``train_path``'s B=4 batch
    of [740, 690, 610, 520] mel frames and one step's draws (seed 1) on the
    card, and ``TrainConfig()`` with an update every step."""
    import torch

    from cosyvoice2_eu_torch.config import TrainConfig, TTSConfig
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.parallel.train_step import make_flow_draws
    from cosyvoice2_eu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # fp32 stays fp32: no TF32
    cfg = TTSConfig().flow
    params = init_flow(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = _flow_batch(cfg, TRAIN_SHAPES[0], 100, dev)
    draws = make_flow_draws(torch.Generator(device=dev).manual_seed(1), batch, cfg.output_size)
    return cfg, TrainConfig(accum_grad=1), params, batch, draws


def _dp_step(cfg, tc, params, batch, draws, mesh):
    """One flow step, data-parallel over ``mesh`` on this process's rows of
    ``batch`` and ``draws`` (None: the plain one-process step on all of
    them); returns (loss, the new parameters, the whole Adam first moment,
    ms, K1/K3/K4 launches, the optimizer).  Under a mesh a second step on
    the same rows follows, its launches uncounted, for the optimizer: that
    step's optimizer stage (``ms``, ``host_ms``: its state adopted at the
    first) and the passes' launches and adoptions over both steps; None
    without a mesh."""
    import torch

    from cosyvoice2_eu_torch.ops import optim_passes as op
    from cosyvoice2_eu_torch.parallel.mesh import shard_batch, shard_rows
    from cosyvoice2_eu_torch.parallel.train_step import init_train_state, make_flow_train_step
    from cosyvoice2_eu_torch.train.optim import make_optimizer
    from cosyvoice2_eu_torch.utils.profiling import StageTimer

    tx = make_optimizer(tc, mesh)
    timer = StageTimer(sync=torch.cuda.synchronize)
    step = make_flow_train_step(cfg, tc, tx, timer=timer, mesh=mesh)
    state = init_train_state(params, tx)
    mine, my_draws = ((batch, draws) if mesh is None
                      else (shard_batch(batch, mesh), shard_rows(draws, mesh)))
    _reset_counts()
    passes = lambda: (op.accumulate.launches, op.update.launches, op.adopt.calls)  # noqa: E731
    before = passes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, mine, my_draws, streaming=False)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = [f.launches for f in _counters()[:3]]
    mu = tx.gather_state(state.opt_state, state.params)["mu"]
    opt = None
    if mesh is not None:
        timer.reset()
        _uncounted(step)(state, mine, my_draws, streaming=False)
        stage = timer.summary()["optimizer"]
        a, b, adopted = (x - y for x, y in zip(passes(), before))
        opt = {"ms": stage["total_s"] * 1e3, "host_ms": stage["host_s"] * 1e3, "micro_steps": 2,
               "pass_a": a, "pass_b": b, "adoptions": adopted}
    return loss, state.params, mu, ms, launched, opt


def _rank_dp(rank: int, world: int) -> dict:
    """(b) on one rank: the DP flow step (rows split 2 / 2) and the
    ``--fsdp 2`` step, each held to the one-process step on the whole batch
    (loss within 1e-5 relative, parameters and Adam's first moment within
    1e-4 x max + 1e-7); each one's optimizer over two steps."""
    from cosyvoice2_eu_torch.parallel.mesh import make_mesh, row_block

    cfg, tc, params, batch, draws = _flow_dp_inputs()
    ref_loss, ref_params, ref_mu, _, _, _ = _uncounted(_dp_step)(cfg, tc, params, batch, draws,
                                                                 None)
    out = {"rows": row_block(len(TRAIN_SHAPES[0]), make_mesh(dp=world))}
    for name, fsdp in (("dp", 1), ("fsdp", world)):
        mesh = make_mesh(dp=world // fsdp, fsdp=fsdp)
        loss, p, mu, ms, launched, opt = _dp_step(cfg, tc, params, batch, draws, mesh)
        out[name] = {"loss": loss, "ref_loss": ref_loss,
                     "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                     "param_err": _tree_err(p, ref_params), "mu_err": _tree_err(mu, ref_mu),
                     "ms": ms, "launched": launched, "optimizer": opt}
    return out


def _tp_decode(params, cfg, prompt, n: int = TP_TOKENS):
    """(tokens, ms a step, steps) of an ``n``-token decode under the draws
    of a generator seeded 7 on the card."""
    import torch

    from cosyvoice2_eu_torch.models import llm as llm_mod

    ids, src, plen, _ = prompt
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    lens = torch.tensor([n], device=ids.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, lens, steps = llm_mod.lm_decode(params, cfg.llm, ids, src, plen, lens, lens, n,
                                          draws=llm_mod.generator_draws(gen, 1, cfg.llm))
    torch.cuda.synchronize()
    return toks[0, :int(lens[0])].cpu(), (time.perf_counter() - t0) * 1e3 / max(steps, 1), steps


def _tp_logits(params, cfg, prompt, cache):
    """The prefill's last logits with its K/V through a cache of dtype
    ``cache`` (``lm_prefill``'s is bf16)."""
    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.models.qwen2 import KVCache, local_kv_heads, qwen2_prefill

    ids, src, plen, p_bucket = prompt
    bb = cfg.llm.backbone
    kv = KVCache.zeros(bb, 1, p_bucket + TP_TOKENS, ids.device, dtype=cache,
                       num_kv_heads=local_kv_heads(params["backbone"], bb))
    last, _ = qwen2_prefill(params["backbone"], bb, llm_mod.embed_mixed(params, ids, src), plen,
                            kv)
    return llm_mod.head_logits(params, cfg.llm, last)


def _rank_tp(rank: int, world: int) -> dict:
    """(c) on one rank: Qwen2-0.5B at its published widths (seed 0), its tp=2
    slices beside the whole LM on the same card.  fp32: the prefill's logits
    (K/V in fp32, and through ``lm_prefill``'s bf16 cache) and
    ``TP_TOKENS`` decoded tokens against tp=1's; bf16 and int8: ms a
    step over ``TP_TIMED`` steps at tp=2 and tp=1, and K2's launches and
    designs at the int8 slices."""
    import torch

    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.models import llm as llm_mod
    from cosyvoice2_eu_torch.parallel.tp import make_tp_mesh, shard_lm_tp
    from cosyvoice2_eu_torch.tools.tp_fp32_drift import tp_prompt
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import cast_floating, quantize_lm_params

    dev = resolve_device("cuda")
    cfg = TTSConfig()
    mesh = make_tp_mesh(world)
    prompt = tp_prompt(cfg, dev)
    ids, src, plen, p_bucket = prompt
    out = {"p_bucket": p_bucket}
    with torch.no_grad():
        whole = llm_mod.init_lm(torch.Generator(device=dev).manual_seed(0), cfg.llm)
        local = shard_lm_tp(whole, mesh, cfg.llm)
        want = llm_mod.head_logits(whole, cfg.llm, llm_mod.lm_prefill(
            whole, cfg.llm, ids, src, plen, TP_TOKENS).last_hidden)
        got = llm_mod.head_logits(local, cfg.llm, llm_mod.lm_prefill(
            local, cfg.llm, ids, src, plen, TP_TOKENS).last_hidden)
        out["logits_err"] = (got - want).abs().max().item()
        out["logits_peak"] = want.abs().max().item()
        want = _tp_logits(whole, cfg, prompt, torch.float32)
        out["logits_err_fp32_kv"] = (_tp_logits(local, cfg, prompt, torch.float32)
                                     - want).abs().max().item()
        out["logits_peak_fp32_kv"] = want.abs().max().item()
        tok1, _, _ = _tp_decode(whole, cfg, prompt)
        tok2, _, _ = _tp_decode(local, cfg, prompt)
        out["tokens"] = (len(tok1), len(tok2))
        out["tokens_equal"] = bool(torch.equal(tok1, tok2))
        out["q_rows"] = tuple(local["backbone"]["layers"][0]["q_proj"]["weight"].shape)
        bf16 = cast_floating(whole, torch.bfloat16)
        del whole, local
        for name, tree in (("bf16", bf16), ("int8", quantize_lm_params(bf16))):
            sliced = shard_lm_tp(tree, mesh, cfg.llm)
            _tp_decode(sliced, cfg, prompt, 2)  # the first call's allocations, off the clock
            _, ms1, _ = _tp_decode(tree, cfg, prompt, TP_TIMED)
            K2_LAUNCHED.clear()
            _reset_counts()
            _, ms2, steps = _tp_decode(sliced, cfg, prompt, TP_TIMED)
            out[name] = {"ms1": ms1, "ms2": ms2, "steps": steps,
                         "k2": _counters()[3].launches, "designs": dict(K2_LAUNCHED)}
            del sliced
    return out


def parallel_path(card: str) -> dict:
    """(a) the data-parallel flow step at world 1 on NCCL against the plain
    step; (b) 2 ranks sharing the card over gloo: the DP flow step and the
    ``--fsdp 2`` step against the one-process step; (c) tp=2 Qwen2-0.5B
    against tp=1.  The ranks share one card: no time here is a multi-GPU
    figure.  Returns the K1/K3/K4 step records and launches of (a) and
    (b), and (c)'s K2 decodes and launches."""
    import torch
    import torch.distributed as dist

    from cosyvoice2_eu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cosy_nccl_") as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rendezvous", rank=0,
                                world_size=1)
        try:
            backend = dist.get_backend()
            cfg, tc, params, batch, draws = _flow_dp_inputs()
            ref_loss, ref_params, ref_mu, ref_ms, _, _ = _uncounted(_dp_step)(
                cfg, tc, params, batch, draws, None)
            loss, p, mu, ms, launched_a, _ = _dp_step(cfg, tc, params, batch, draws, make_mesh())
        finally:
            dist.destroy_process_group()
    rel, p_err, mu_err = (abs(loss - ref_loss) / abs(ref_loss), _tree_err(p, ref_params),
                          _tree_err(mu, ref_mu))
    ok = (backend == "nccl" and rel <= 1e-5 and p_err <= 1.0 and mu_err <= 1.0
          and launched_a == [56] * 3)
    print(f"parallel (a) world 1 on {backend}: the DP flow step at TTSConfig().flow on B=4 "
          f"{TRAIN_SHAPES[0]}: loss {loss:.6f} vs plain {ref_loss:.6f} (rel {rel:.2e}, tol "
          f"1e-5); parameters at {p_err:.3f} and Adam's first moment at {mu_err:.3f} of 1e-4 x "
          f"max + 1e-7; {ms:.1f} ms a step (plain {ref_ms:.1f} ms); K1/K3/K4 launches "
          f"{launched_a} [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("parallel (a): the world-1 NCCL step disagrees with the plain step")
    del params, ref_params, ref_mu, p, mu, batch, draws
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    steps = [{"step": 0, "lens": TRAIN_SHAPES[0], "chunk": 0}]
    launched = list(launched_a)
    for r, res in enumerate(_run_ranks("dp", PARALLEL_WORLD, 600)):
        start, stop = res["rows"]
        for name in ("dp", "fsdp"):
            m = res[name]
            ok = (m["loss_rel"] <= 1e-5 and m["param_err"] <= 1.0 and m["mu_err"] <= 1.0
                  and m["launched"] == [56] * 3)
            print(f"parallel (b) rank {r} {name} (2 ranks sharing the card over gloo; rows "
                  f"{start}-{stop - 1} of B=4): loss {m['loss']:.6f} vs one process "
                  f"{m['ref_loss']:.6f} (rel {m['loss_rel']:.2e}, tol 1e-5); parameters at "
                  f"{m['param_err']:.3f}, Adam's first moment at {m['mu_err']:.3f} of 1e-4 x max "
                  f"+ 1e-7; {m['ms']:.1f} ms a step; K1/K3/K4 launches {m['launched']} "
                  f"[{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"parallel (b): rank {r}'s {name} step disagrees with the "
                                 "one-process step")
            # the optimizer over two steps (accum_grad 1): at fsdp 1 the flat
            # path (pass A for the norm and pass B a step), at fsdp 2 the
            # slices (pass B a step; the norm is the group's)
            o = m["optimizer"]
            want = (o["micro_steps"] if name == "dp" else 0, o["micro_steps"], 1)
            ok = (o["pass_a"], o["pass_b"], o["adoptions"]) == want
            print(f"parallel (b) rank {r} {name} optimizer: the second step's {o['ms']:.2f} ms "
                  f"(host {o['host_ms']:.2f} ms); over {o['micro_steps']} steps pass A "
                  f"{o['pass_a']} launches, pass B {o['pass_b']}, {o['adoptions']} adoption "
                  f"(expected {want}) [{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"parallel (b): rank {r}'s {name} optimizer launched its "
                                 "passes wrongly")
            OPTIMIZER_BY_PATH.setdefault(f"parallel/{name}", []).append(
                {"micro_steps": o["micro_steps"], "emissions": o["micro_steps"],
                 "pass_a": o["pass_a"], "pass_b": o["pass_b"], "trees": 1,
                 "adoptions": o["adoptions"], "ms": o["ms"], "host_ms": o["host_ms"]})
            launched = [a + b for a, b in zip(launched, m["launched"])]
            steps.append({"step": len(steps), "lens": TRAIN_SHAPES[0][start:stop], "chunk": 0,
                          "t": max(TRAIN_SHAPES[0])})
    print(f"parallel (b): 2 ranks in {time.perf_counter() - t0:.1f} s, their start included "
          f"[{card}]")

    t0 = time.perf_counter()
    decodes, k2 = [], 0
    for r, res in enumerate(_run_ranks("tp", PARALLEL_WORLD, 600)):
        tol32, tol16 = 1e-5 * res["logits_peak_fp32_kv"], 1e-3 * res["logits_peak"]
        ok = (res["logits_err_fp32_kv"] <= tol32 and res["logits_err"] <= tol16
              and res["tokens_equal"] and res["tokens"] == (TP_TOKENS, TP_TOKENS)
              and res["q_rows"] == (448, 896))
        print(f"parallel (c) rank {r}: tp=2 Qwen2-0.5B fp32 (q_proj slice {res['q_rows']}): "
              f"prefill logits max_abs_err with fp32 K/V {res['logits_err_fp32_kv']:.3e} (tol "
              f"1e-5 x max|logits| = {tol32:.3e}), through the bf16 KV cache "
              f"{res['logits_err']:.3e} (tol 1e-3 x max|logits| = {tol16:.3e}); "
              f"{res['tokens']} tokens at tp=1 / tp=2, equal: {res['tokens_equal']} "
              f"[{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"parallel (c): rank {r}'s tp=2 decode disagrees with tp=1")
        for name in ("bf16", "int8"):
            m = res[name]
            want_k2 = 168 + 169 * m["steps"] if name == "int8" else 0
            designs = {f"{src}@M={rows}": n for (src, rows), n in sorted(m["designs"].items())}
            ok = m["k2"] == want_k2 and (name == "bf16" or set(m["designs"]) == {
                ("int8_matmul_sm90.cu", res["p_bucket"]), ("int8_matmul_decode_sm90.cu", 1)})
            print(f"parallel (c) rank {r} {name}: {m['ms2']:.2f} ms a step at tp=2 beside "
                  f"{m['ms1']:.2f} at tp=1 ({m['steps']} steps; both ranks share the card: not "
                  f"a scaling figure); K2 launches {m['k2']} (expected {want_k2}) {designs} "
                  f"[{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"parallel (c): rank {r}'s {name} decode launched K2 wrongly")
        decodes.append((1, res["p_bucket"], res["int8"]["steps"], None, PARALLEL_WORLD))
        k2 += res["int8"]["k2"]
    print(f"parallel (c): 2 ranks in {time.perf_counter() - t0:.1f} s; parallel phase "
          f"{time.perf_counter() - t_phase:.1f} s; K1/K3/K4 launches {launched} over "
          f"{len(steps)} rank-steps, K2 {k2} [{card}]")
    return {"steps": steps, "launches": launched, "decodes": decodes, "k2": k2}


def _write_pcm16(path: str, sig, sr: int) -> None:
    import wave

    import numpy as np

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16).tobytes())


def eval_path(card: str) -> tuple[list, int]:
    """``run_eval.evaluate_model`` through ``Cosy2EU.tts`` at ``TTSConfig()``
    (random weights, seed 0) with ``frontend_path``'s seeded frontend models
    (the FSQ tokenizer and CAM++ on the card), over a 4-utterance,
    2-speaker dataset written from seeded harmonics; SECS on the card's
    CAM++.  Gates: 4 rows, none failed; rtf, mcd, mcd_rel, lsd and secs
    finite; each pitch metric finite exactly where the JAX package's guards
    leave it defined (``metrics.defined_pitch_metrics``: none under 5 voiced
    frames on a side, only vuv_error under 5 frames voiced on both sides
    after the alignment), NaN elsewhere; K1 560 times a flow call.  Prints the summary and each
    sample's synthesis ms and metric host ms.  Returns the flow calls' K1
    shapes and K1's launches."""
    import csv

    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.eval import metrics as eval_metrics
    from cosyvoice2_eu_torch.eval import run_eval
    from cosyvoice2_eu_torch.frontend import frontend as fe_mod
    from cosyvoice2_eu_torch.models import campplus as cam
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.train.pitch import estimate_f0

    t_phase = time.perf_counter()
    st_cfg, cam_cfg = st.SpeechTokenizerConfig(), cam.CAMPPlusConfig()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    st_params = st.init_speech_tokenizer(gen, st_cfg)
    cam_params = _perturbed_norms(cam.init_campplus(gen, cam_cfg), gen)
    model = cosy.load(seed=0, download=False, device="cuda")
    cfg = model._cfg
    spk_fn = fe_mod.make_spk_embedding_fn(cam_params, cam_cfg, device="cuda")
    fe = fe_mod.Frontend(cfg, tokenizer=model._frontend.tokenizer,
                         speech_tokenizer_fn=fe_mod.make_speech_tokenizer_fn(
                             st_params, st_cfg, device="cuda"),
                         spk_embedding_fn=spk_fn, device="cuda")
    api = cosy.Cosy2EU(model._model, fe, cfg)
    tm = model._model
    texts = {"spk1": ("Bonjour.", "Merci!"), "spk2": ("Salut!", "Danke.")}
    rng = np.random.default_rng(0)
    synth_ms, metric_ms, gen_voiced, defined, calls = [], [], [], [], []
    _record_flow_calls(tm, calls)
    metrics_for_pair = run_eval.metrics_for_pair

    def timed_metrics(ref, wav, *args, **kwargs):
        gen_voiced.append(int((estimate_f0(wav, cfg.sample_rate) > 0).sum()))
        t0 = time.perf_counter()
        row = metrics_for_pair(ref, wav, *args, **kwargs)
        metric_ms.append((time.perf_counter() - t0) * 1e3)
        defined.append(eval_metrics.defined_pitch_metrics(ref, wav, args[0]))
        return row

    def synthesize(text, prompt_path):
        t0 = time.perf_counter()
        wav, _ = api.tts(text, prompt_path)
        secs = time.perf_counter() - t0
        synth_ms.append(secs * 1e3)
        return wav[0], secs

    run_eval.metrics_for_pair = timed_metrics
    try:
        with tempfile.TemporaryDirectory(prefix="cosy_eval_") as d:
            for spk, f0 in (("spk1", 140.0), ("spk2", 220.0)):
                os.makedirs(os.path.join(d, "data", spk, "a"))
                for i, text in enumerate(texts[spk]):
                    stem = os.path.join(d, "data", spk, "a", f"{spk}_utt{i}")
                    _write_pcm16(stem + ".wav", _harmonic(rng, 3.0, f0 + 15 * i, 4.0, 5.0),
                                 cfg.sample_rate)
                    with open(stem + ".normalized.txt", "w") as f:
                        f.write(text)
            samples = run_eval.read_dataset(os.path.join(d, "data"))
            ref_voiced = {s.utt_id: int((estimate_f0(fe_mod.load_wav(
                s.wav_path, cfg.sample_rate), cfg.sample_rate) > 0).sum()) for s in samples}
            _reset_counts()
            _reset_peak()
            summary = run_eval.evaluate_model(synthesize, samples, os.path.join(d, "out"),
                                              "port_eval", sr=cfg.sample_rate, embed_fn=spk_fn)
            with open(os.path.join(d, "out", "port_eval_results.csv")) as f:
                rows = list(csv.DictReader(f))
    finally:
        run_eval.metrics_for_pair = metrics_for_pair
    pitch = ("gpe", "f0_rmse", "f0_corr", "vuv_error")
    finite = lambda r, k: math.isfinite(float(r[k]))  # noqa: E731
    ok = (summary["n"] == 4 and summary["n_failed"] == 0 and len(rows) == 4
          and len(synth_ms) == len(metric_ms) == len(gen_voiced) == len(defined) == 4)
    for r, s_ms, m_ms, g_voiced, r_defined in zip(rows, synth_ms, metric_ms, gen_voiced,
                                                   defined):
        row_ok = (all(finite(r, k) for k in ("rtf", "mcd", "mcd_rel", "lsd", "secs"))
                  and all(finite(r, k) == (k in r_defined) for k in pitch))
        ok = ok and row_ok
        print(f"eval sample {r['utt_id']} ({r['speaker']}): synthesis {s_ms:.1f} ms, metrics "
              f"{m_ms:.1f} ms on the host; " + ", ".join(f"{k} {r[k]}" for k in (
                  "audio_duration", "rtf", "mcd", "mcd_rel", "lsd", "secs") + pitch)
              + f"; voiced frames: reference {ref_voiced[r['utt_id']]}, synthesis {g_voiced}; "
              f"defined pitch metrics {len(r_defined)} of 4 [{card}] "
              f"{'ok' if row_ok else 'FAIL'}")
    print(f"eval summary: {json.dumps(summary)}; synthesis {sum(synth_ms):.1f} ms, metrics "
          f"{sum(metric_ms):.1f} ms over {len(rows)} samples; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the eval phase failed its checks")
    launches = _path_launches("eval phase", card, len(calls))
    del model, api, tm, fe, st_params, cam_params
    gc.collect()
    torch.cuda.empty_cache()
    return [_k1_shape(cfg, *c[:3]) for c in calls], launches


# ---------------------------------------------------------------------------
# native checkpoints, the ONNX graph executor, the ASR decoder
# ---------------------------------------------------------------------------

ORBAX_FIXTURE = os.path.join(REPO, "tests", "data", "orbax_fixture")
ORBAX_FIXTURE_NPZ = ORBAX_FIXTURE + ".npz"


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _check_orbax_fixture(card: str) -> None:
    """``load_pytree`` on the JAX package's orbax checkpoint committed under
    ``tests/data/`` (fp32, bf16 and int32 leaves, a leaf of 8 chunks, a
    value held in a data file): every leaf bit-equal to the ``.npz`` beside
    it.  Shows the reader and the system's libzstd on this machine."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.runtime import orbax_read
    from cosyvoice2_eu_torch.runtime.checkpoint import load_pytree

    got = {k.lstrip("/"): v for k, v in _by_path(load_pytree(ORBAX_FIXTURE)).items()}
    with np.load(ORBAX_FIXTURE_NPZ) as z:
        want = {k.split("@")[0]: (k.endswith("@bf16"), z[k]) for k in z.files}
    bad = sorted(set(got) ^ set(want))
    for k, (bf16, bits) in want.items():
        g = got.get(k)
        if g is None:
            continue
        same = (g.dtype == torch.bfloat16 and np.array_equal(
            g.view(torch.int16).numpy().view(np.uint16), bits)) if bf16 else (
            g.numpy().dtype == bits.dtype and np.array_equal(g.numpy(), bits))
        if not same:
            bad.append(k)
    ok = not bad
    print(f"orbax fixture: {len(want)} leaves of {ORBAX_FIXTURE} read with "
          f"{orbax_read.ZSTD_LIBRARY}, bit-equal to its .npz: {ok} {bad or ''} [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the orbax reader disagrees with the committed fixture")


def native_path(card: str) -> tuple[list, int]:
    """A training run's output served: the seed-0 model's parameters
    written as the port's trainer writes them (``save_checkpoint`` into one
    experiment dir a component, HiFT as a GAN whole tree with the
    published-width discriminators), extracted by
    ``tools/extract_for_inference`` with a run id, then ``load(model_dir=...,
    final=False, *_run_id=...)`` on the card.  Gates: the extracted trees
    bit-equal to the written ones, every parameter of the loaded model
    ``torch.equal`` to the in-memory ``load(seed=0)``'s, and one
    ``Cosy2EU.tts`` with its tokens and audio within 1e-3; prints the bytes
    written and read and the load seconds.  Then the committed orbax
    fixture (``_check_orbax_fixture``).  Returns the flow calls' K1 shapes
    and K1's launches."""
    import numpy as np
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm import init_lm
    from cosyvoice2_eu_torch.runtime.checkpoint import load_pytree
    from cosyvoice2_eu_torch.tools import extract_for_inference
    from cosyvoice2_eu_torch.train.executor import save_checkpoint
    from cosyvoice2_eu_torch.train.gan import init_discriminator

    cfg = TTSConfig()
    prompt = _prompt(cfg, 3.0)
    text = SHORT_TEXT
    run = "1500-averaged-blanken-FR"
    gen = torch.Generator(device="cuda")  # the weights load(seed=0) draws
    gen.manual_seed(0)
    params = {"llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
              "hift": init_hift(gen, cfg.hift)}
    disc = init_discriminator(torch.Generator(device="cuda").manual_seed(1))
    with tempfile.TemporaryDirectory(prefix="cosy_native_") as root:
        t0 = time.perf_counter()
        for key in ("llm", "flow"):
            os.makedirs(os.path.join(root, f"exp_{key}"))
            save_checkpoint(os.path.join(root, f"exp_{key}"), "epoch_3_step_1200",
                            params[key], {"epoch": 3, "step": 1200, "cv_loss": 1.25})
        os.makedirs(os.path.join(root, "exp_hift"))
        save_checkpoint(os.path.join(root, "exp_hift"), "epoch_2_whole",
                        {"generator": params["hift"], "discriminator": disc},
                        {"epoch": 2, "step": 900})
        write_s = time.perf_counter() - t0
        written = sum(_dir_bytes(os.path.join(root, f"exp_{k}")) for k in ("llm", "flow", "hift"))
        model_dir = os.path.join(root, "model")
        t0 = time.perf_counter()
        for key, comp in (("llm", "llm"), ("flow", "flow"), ("hift", "hifigan")):
            extract_for_inference.main(["--exp-dir", os.path.join(root, f"exp_{key}"),
                                        "--component", comp, "--out-dir", model_dir,
                                        "--run-id", run])
        extract_s = time.perf_counter() - t0
        extracted = _dir_bytes(model_dir)
        trees_equal = True
        for key in ("llm", "flow", "hift"):
            back, wrote = (_by_path(load_pytree(os.path.join(model_dir, f"{key}-{run}"))),
                           _by_path(params[key]))
            trees_equal &= sorted(back) == sorted(wrote) and all(
                back[k].dtype == wrote[k].dtype and torch.equal(back[k], wrote[k].cpu())
                for k in wrote)
        del params, disc

        _reset_counts()
        calls, tokens_ref, tokens_got = [], {}, {}
        ref = cosy.load(config=cfg, seed=0, device="cuda")
        _record_flow_calls(ref._model, calls)
        _record_tokens(ref._model, tokens_ref)
        want = ref.tts(text, prompt)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_api = cosy.load(config=cfg, model_dir=model_dir, final=False, llm_run_id=run,
                            flow_run_id=run, hifigan_run_id=run, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got_p, ref_p = (_by_path(m._model.params) for m in (got_api, ref))
        exact = sorted(got_p) == sorted(ref_p) and all(
            got_p[k].dtype == ref_p[k].dtype and torch.equal(got_p[k], ref_p[k]) for k in ref_p)
        _record_flow_calls(got_api._model, calls)
        _record_tokens(got_api._model, tokens_got)
        got = got_api.tts(text, prompt)[0]
    n_tok = got_api._model.last_n_tokens
    same_tokens = np.array_equal(tokens_ref["tokens"], tokens_got["tokens"])
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    ok = (trees_equal and exact and same_tokens and err <= 1e-3 and np.isfinite(got).all()
          and got.shape == (1, n_tok * 960) and not os.path.exists(root))
    print(f"native checkpoint: the trainer's checkpoints {written} bytes written in "
          f"{write_s:.2f} s; extract_for_inference wrote {extracted} bytes in {extract_s:.2f} s, "
          f"trees bit-equal to the written ones: {trees_equal}; load(model_dir=..., final=False, "
          f"run ids, device='cuda') read {extracted} bytes in {load_s:.2f} s "
          f"({extracted / load_s / 1e9:.2f} GB/s, the files warm in the page cache); every "
          f"parameter torch.equal to the in-memory model's: {exact}; tts of "
          f"{len(text.encode())} text bytes: the same {n_tok} tokens: {same_tokens}, audio "
          f"max_abs_err={err:.3e} (tol 1e-3) [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the native checkpoint path failed its checks")
    launches = _path_launches("native checkpoint", card, len(calls))
    _check_orbax_fixture(card)
    del ref, got_api
    gc.collect()
    torch.cuda.empty_cache()
    return [_k1_shape(cfg, *c[:3]) for c in calls], launches


class _OnnxGraph:
    """A minimal ONNX protobuf writer (the model, graph, node, attribute and
    tensor messages the frontend graphs need), after ``tests/onnx_builder.py``;
    parts are joined once, so a graph of hundreds of MB writes in one pass."""

    _TYPES = {"float32": 1, "int32": 6, "int64": 7}

    def __init__(self):
        self.nodes, self.inits, self._n = [], {}, 0

    @staticmethod
    def _varint(v: int) -> bytes:
        v = v + (1 << 64) if v < 0 else v
        out = bytearray()
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | 0x80 if v else b)
            if not v:
                return bytes(out)

    def _key(self, field: int, wire: int) -> bytes:
        return self._varint(field << 3 | wire)

    def _len(self, field: int, data: bytes) -> bytes:
        return self._key(field, 2) + self._varint(len(data)) + data

    def _int(self, field: int, v: int) -> bytes:
        return self._key(field, 0) + self._varint(v)

    def _tensor(self, name: str, arr) -> bytes:
        import numpy as np

        arr = np.ascontiguousarray(arr)
        return b"".join([*(self._int(1, d) for d in arr.shape),
                         self._int(2, self._TYPES[arr.dtype.name]), self._len(8, name.encode()),
                         self._len(9, arr.tobytes())])

    def _attr(self, name: str, value) -> bytes:
        import struct

        out = self._len(1, name.encode())
        if isinstance(value, int):
            return out + (self._int(3, value) if value else b"") + self._int(20, 2)
        if isinstance(value, float):
            return out + (self._key(2, 5) + struct.pack("<f", value) if value else b"") + \
                self._int(20, 1)
        if isinstance(value, (list, tuple)):
            return out + b"".join(self._int(8, v) for v in value) + self._int(20, 7)
        raise TypeError(f"attribute {name}={value!r}")

    def init(self, arr) -> str:
        import numpy as np

        self._n += 1
        name = f"w_{self._n}"
        self.inits[name] = np.asarray(arr)
        return name

    def add(self, op: str, inputs, n_out: int = 1, **attrs):
        outs = []
        for _ in range(n_out):
            self._n += 1
            outs.append(f"{op.lower()}_{self._n}")
        self.nodes.append(b"".join([*(self._len(1, i.encode()) for i in inputs),
                                    *(self._len(2, o.encode()) for o in outs),
                                    self._len(3, f"{op}_{outs[0]}".encode()),
                                    self._len(4, op.encode()),
                                    *(self._len(5, self._attr(k, v)) for k, v in attrs.items())]))
        return outs[0] if n_out == 1 else outs

    def save(self, path: str, inputs, outputs) -> str:
        def value_info(name, elem):
            tensor = self._len(2, self._len(1, self._int(1, elem))) if elem else b""
            return self._len(1, name.encode()) + tensor

        graph = b"".join([*(self._len(1, n) for n in self.nodes), self._len(2, b"synthetic"),
                          *(self._len(5, self._tensor(k, v)) for k, v in self.inits.items()),
                          *(self._len(11, value_info(i, 1)) for i in inputs),
                          *(self._len(12, value_info(o, 0)) for o in outputs)])
        with open(path, "wb") as f:
            f.write(self._int(1, 8) + self._len(7, graph) + self._len(8, self._int(2, 17)))
        return path


def _gelu_nodes(g, x):
    """Erf-decomposed GELU, as torch exports it."""
    import numpy as np

    d = g.add("Div", [x, g.init(np.float32(math.sqrt(2.0)))])
    a = g.add("Add", [g.add("Erf", [d]), g.init(np.float32(1.0))])
    return g.add("Mul", [g.add("Mul", [x, a]), g.init(np.float32(0.5))])


def write_tokenizer_onnx(path: str, cfg, rng, t_in: int) -> str:
    """A speech-tokenizer graph shaped like ``torch.onnx.export``'s (the
    builder of ``tests/test_onnx_convert.py``) at ``cfg``'s widths, random
    weights from ``rng``, positions frozen for ``t_in`` whisper frames."""
    import numpy as np

    from cosyvoice2_eu_torch.models import speech_tokenizer as st

    g, d, heads = _OnnxGraph(), cfg.d_model, cfg.num_heads
    hd = d // heads
    t_out = ((t_in - 1) // 2) // 2 + 1

    def conv(x, cin, cout):
        w = g.init(rng.standard_normal((cout, cin, 3), np.float32) * 0.2)
        b = g.init(rng.standard_normal(cout, np.float32) * 0.1)
        return g.add("Conv", [x, w, b], strides=[2], pads=[1, 1], dilations=[1], group=1)

    def linear(x, cin, cout, bias=True):
        w = rng.standard_normal((cin, cout), np.float32) * np.float32(0.4 / math.sqrt(cin))
        y = g.add("MatMul", [x, g.init(w)])  # MatMul stores (in, out)
        return g.add("Add", [y, g.init(rng.standard_normal(cout, np.float32) * 0.05)]) \
            if bias else y

    def ln(x):
        return g.add("LayerNormalization",
                     [x, g.init(1.0 + 0.1 * rng.standard_normal(d, np.float32)),
                      g.init(rng.standard_normal(d, np.float32) * 0.05)], axis=-1,
                     epsilon=1e-5)

    x = _gelu_nodes(g, conv("mel", cfg.n_mels, d))
    x = g.add("Transpose", [_gelu_nodes(g, conv(x, d, d))], perm=[0, 2, 1])
    x = g.add("Add", [x, g.init(st._sinusoid_pos(t_out, d).numpy().astype(np.float32))])
    shape4 = g.init(np.asarray([1, t_out, heads, hd], np.int64))
    shape3 = g.init(np.asarray([1, t_out, d], np.int64))
    for _ in range(cfg.num_layers):
        h = ln(x)
        q, k, v = linear(h, d, d), linear(h, d, d, bias=False), linear(h, d, d)
        qt, kt, vt = (g.add("Transpose", [g.add("Reshape", [y, shape4])], perm=perm)
                      for y, perm in ((q, [0, 2, 1, 3]), (k, [0, 2, 3, 1]), (v, [0, 2, 1, 3])))
        sc = g.add("Mul", [g.add("MatMul", [qt, kt]), g.init(np.float32(1.0 / math.sqrt(hd)))])
        ctx = g.add("MatMul", [g.add("Softmax", [sc], axis=-1), vt])
        ctx = g.add("Reshape", [g.add("Transpose", [ctx], perm=[0, 2, 1, 3]), shape3])
        x = g.add("Add", [x, linear(ctx, d, d)])
        x = g.add("Add", [x, linear(_gelu_nodes(g, linear(ln(x), d, cfg.ffn_dim)),
                                    cfg.ffn_dim, d)])
    th = g.add("Tanh", [linear(x, d, cfg.fsq_dim)])
    r = g.add("Round", [g.add("Mul", [th, g.init(np.float32(st.FSQ_TANH_SCALE))])])
    dg = g.add("Add", [r, g.init(np.float32(1.0))])
    pw = g.add("Mul", [dg, g.init((3.0 ** np.arange(cfg.fsq_dim)).astype(np.float32))])
    s = g.add("ReduceSum", [pw], axes=[-1], keepdims=0)
    return g.save(path, ["mel"], [g.add("Cast", [s], to=7)])


def write_campplus_onnx(path: str, cfg, rng, t_in: int) -> str:
    """A CAM++ graph shaped like ``torch.onnx.export``'s (the builder of
    ``tests/test_onnx_convert.py``) at ``cfg``'s widths, random weights and
    norm statistics from ``rng``, for ``t_in`` fbank frames."""
    import numpy as np

    g = _OnnxGraph()

    def i64(v):
        return g.init(np.asarray(v, np.int64))

    def conv2(x, cin, cout, k, stride=(1, 1), pad=(1, 1)):
        w = rng.standard_normal((cout, cin, k, k), np.float32) * np.float32(
            0.5 / math.sqrt(cin * k * k))
        return g.add("Conv", [x, g.init(w)], strides=list(stride),
                     pads=[pad[0], pad[1], pad[0], pad[1]], dilations=[1, 1], group=1)

    def conv1(x, cin, cout, k, stride=1, pad=0, dil=1, bias=False):
        ins = [x, g.init(rng.standard_normal((cout, cin, k), np.float32)
                         * np.float32(0.5 / math.sqrt(cin * k)))]
        if bias:
            ins.append(g.init(rng.standard_normal(cout, np.float32) * 0.05))
        return g.add("Conv", ins, strides=[stride], pads=[pad, pad], dilations=[dil], group=1)

    def bn(x, c):
        stats = [(0.5 + rng.random(c)).astype(np.float32),
                 rng.standard_normal(c, np.float32) * 0.1,
                 rng.standard_normal(c, np.float32) * 0.1, (0.5 + rng.random(c)).astype(np.float32)]
        return g.add("BatchNormalization", [x, *(g.init(a) for a in stats)], epsilon=1e-5)

    def relu(x):
        return g.add("Relu", [x])

    fc = cfg.fcm_channels
    x = g.add("Unsqueeze", [g.add("Transpose", ["fbank"], perm=[0, 2, 1]), i64([1])])
    x = relu(bn(conv2(x, 1, fc, 3), fc))
    for n_blocks in cfg.fcm_blocks:
        for bi in range(n_blocks):
            stride = 2 if bi == 0 else 1
            h = bn(conv2(relu(bn(conv2(x, fc, fc, 3, (stride, 1)), fc)), fc, fc, 3), fc)
            sc = bn(conv2(x, fc, fc, 1, (stride, 1), (0, 0)), fc) if stride != 1 else x
            x = relu(g.add("Add", [h, sc]))
    x = relu(bn(conv2(x, fc, fc, 3, (2, 1)), fc))
    freq = cfg.feat_dim // (2 ** (len(cfg.fcm_blocks) + 1))
    x = g.add("Reshape", [x, i64([1, fc * freq, t_in])])
    x = relu(bn(conv1(x, fc * freq, cfg.init_channels, 5, stride=2, pad=2), cfg.init_channels))
    t = (t_in + 4 - 5) // 2 + 1

    def seg_pool(h, c):
        sp = g.add("AveragePool", [h], kernel_shape=[cfg.seg_len], strides=[cfg.seg_len],
                   ceil_mode=1)
        e = g.add("Expand", [g.add("Unsqueeze", [sp, i64([3])]),
                             i64([1, c, -(-t // cfg.seg_len), cfg.seg_len])])
        r = g.add("Reshape", [e, i64([1, c, -1])])
        return g.add("Slice", [r, i64([0]), i64([t]), i64([2]), i64([1])])

    channels = cfg.init_channels
    for n_layers, dil in zip(cfg.block_layers, cfg.block_dilations):
        for _ in range(n_layers):
            h = relu(bn(conv1(relu(bn(x, channels)), channels, cfg.bn_channels, 1),
                        cfg.bn_channels))
            y = conv1(h, cfg.bn_channels, cfg.growth_rate, cfg.kernel_size,
                      pad=dil * (cfg.kernel_size - 1) // 2, dil=dil)
            ctx = g.add("Add", [g.add("ReduceMean", [h], axes=[2], keepdims=1),
                                seg_pool(h, cfg.bn_channels)])
            g1 = relu(conv1(ctx, cfg.bn_channels, cfg.bn_channels // 2, 1, bias=True))
            gate = g.add("Sigmoid", [conv1(g1, cfg.bn_channels // 2, cfg.growth_rate, 1,
                                           bias=True)])
            x = g.add("Concat", [x, g.add("Mul", [y, gate])], axis=1)
            channels += cfg.growth_rate
        x = conv1(relu(bn(x, channels)), channels, channels // 2, 1)
        channels //= 2
    x = relu(bn(x, channels))
    mean = g.add("ReduceMean", [x], axes=[2], keepdims=1)
    dev = g.add("Sub", [x, mean])
    var = g.add("Mul", [g.add("ReduceSum", [g.add("Mul", [dev, dev])], axes=[2], keepdims=0),
                        g.init(np.float32(1.0 / (t - 1)))])
    stats = g.add("Concat", [g.add("Squeeze", [mean, i64([2])]), g.add("Sqrt", [var])], axis=1)
    e = conv1(g.add("Unsqueeze", [stats, i64([2])]), channels * 2, cfg.embedding_size, 1)
    emb = g.add("Squeeze", [bn(e, cfg.embedding_size), i64([2])])
    return g.save(path, ["fbank"], [emb])


def _no_launches(what: str, card: str) -> None:
    """Read the counts after a path that must launch no kernel."""
    launches = [f.launches for f in _counters()]
    print(f"{what}: K1/K3/K4/K2 launches {launches} (none expected) [{card}]")
    if any(launches):
        raise SystemExit(f"{what} launched a kernel")


def onnx_path(card: str) -> None:
    """The reference's frontend binaries as a user's model dir holds them:
    ``speech_tokenizer_v2.onnx`` and ``campplus.onnx`` written at the
    port's default ``SpeechTokenizerConfig`` (128 mels, d 1280, 20 heads, 6
    layers, ffn 5120) and ``CAMPPlusConfig`` widths with seeded weights, a
    3 s synthetic prompt through ``load_frontend_fns`` structurally (the
    converted models on the card) and with ``COSY2EU_ONNX_EXECUTOR=1`` (the
    graph executor, its convolutions and pools on the card).  Gates: equal
    FSQ codes, x-vectors at a cosine of at least 0.9999, no kernel launched;
    prints each way's ms a prompt second."""
    import numpy as np
    import torch

    from cosyvoice2_eu_torch.models import campplus as cam
    from cosyvoice2_eu_torch.models import speech_tokenizer as st
    from cosyvoice2_eu_torch.runtime.onnx_fallback import load_frontend_fns

    seconds = 3.0
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * np.cumsum(120.0 + 80.0 * t / seconds) / 16000
    wav = (sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3, 4))
           + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    frames = int(seconds * 100)  # whisper frames of the prompt
    fbank_frames = (wav.size - 400) // 160 + 1
    _reset_counts()
    with tempfile.TemporaryDirectory(prefix="cosy_onnx_") as d:
        t0 = time.perf_counter()
        st_path = write_tokenizer_onnx(os.path.join(d, "speech_tokenizer_v2.onnx"),
                                       st.SpeechTokenizerConfig(), rng, frames)
        cam_path = write_campplus_onnx(os.path.join(d, "campplus.onnx"), cam.CAMPPlusConfig(),
                                       rng, fbank_frames)
        sizes = [os.path.getsize(p) for p in (st_path, cam_path)]
        print(f"onnx: graphs written ({sizes[0]} + {sizes[1]} bytes) in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        out = {}
        for way in ("structural", "executor"):
            if way == "executor":
                os.environ["COSY2EU_ONNX_EXECUTOR"] = "1"
            try:
                t0 = time.perf_counter()
                st_fn, cam_fn = load_frontend_fns(st_path, cam_path, device="cuda")
                build_s = time.perf_counter() - t0
            finally:
                os.environ.pop("COSY2EU_ONNX_EXECUTOR", None)
            st_fn(wav), cam_fn(wav)  # first calls (allocations, cuDNN plans)
            torch.cuda.synchronize()
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                codes = st_fn(wav)
                t1 = time.perf_counter()
                emb = cam_fn(wav)
                torch.cuda.synchronize()
                runs.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            st_ms, cam_ms = (float(np.median([r[i] for r in runs])) for i in (0, 1))
            out[way] = (codes, emb, st_ms, cam_ms)
            print(f"onnx {way}: load_frontend_fns {build_s:.2f} s; {len(codes)} codes; speech "
                  f"tokenizer {st_ms:.1f} ms ({st_ms / seconds:.1f} ms a prompt second), CAM++ "
                  f"{cam_ms:.1f} ms ({cam_ms / seconds:.1f} ms a prompt second), median of 3 "
                  f"warm [{card}]")
    (c_s, e_s, st_s, cam_s), (c_x, e_x, st_x, cam_x) = out["structural"], out["executor"]
    cos = float(np.dot(e_s, e_x) / (np.linalg.norm(e_s) * np.linalg.norm(e_x)))
    equal = c_s.shape == c_x.shape and np.array_equal(c_s, c_x)
    ok = equal and len(c_s) == frames // 4 and cos >= 0.9999 and np.isfinite(e_s).all()
    print(f"onnx: structural vs executor on a {seconds:.0f} s prompt: FSQ codes equal: {equal} "
          f"({int((c_s == c_x).sum()) if c_s.shape == c_x.shape else 0}/{len(c_s)}), x-vector "
          f"cosine {cos:.7f} (gate 0.9999); executor {(st_x + cam_x) / seconds:.1f} ms a prompt "
          f"second beside the structural path's {(st_s + cam_s) / seconds:.1f} [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the ONNX executor disagrees with the structural conversion")
    _no_launches("onnx phase", card)
    gc.collect()
    torch.cuda.empty_cache()


ASR_REL_TOL = 1e-5  # fp32 on the card (TF32 off) vs the CPU, relative to the largest value


def asr_decoder_path(card: str) -> None:
    """The ASR decoder at ``AsrDecoderConfig()``'s widths (6 blocks, d 256,
    4 heads, ffn 2048, 4233 tokens; seeded weights, fp32): an n-best of 10
    hypotheses of 20 tokens over 75 memory frames rescored by the batched
    forward and by 20 one-step calls through the layer-output cache, and
    ``moe_ffn`` at 8 experts, top 2, idim 256, hidden 2048, each on the
    card against the CPU with the same weights, within ``ASR_REL_TOL`` of
    the largest value.  Plain PyTorch: no kernel launched."""
    import torch

    from cosyvoice2_eu_torch.config import AsrDecoderConfig
    from cosyvoice2_eu_torch.models import decoder as dec
    from cosyvoice2_eu_torch.utils.device import resolve_device
    from cosyvoice2_eu_torch.utils.params import tree_map

    resolve_device("cuda")  # TF32 off
    cfg = AsrDecoderConfig()
    gen = torch.Generator().manual_seed(0)
    params = dec.init_transformer_decoder(gen, cfg)
    moe = dec.init_moe_ffn(gen, 8, 256, 2048)
    n, l, t_mem = 10, 20, 75
    memory = torch.randn(n, t_mem, cfg.encoder_output_size, generator=gen)
    mem_lens = torch.full((n,), t_mem)
    ys = torch.randint(0, cfg.vocab_size, (n, l), generator=gen)
    ys_lens = torch.randint(12, l + 1, (n,), generator=gen)
    ys_lens[0] = l
    x = torch.randn(4, 50, 256, generator=gen)

    def run(dev):
        p, m = (tree_map(lambda a: a.to(dev), t) for t in (params, moe))
        args = [a.to(dev) for a in (memory, mem_lens)]
        with torch.inference_mode():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = dec.transformer_decoder_forward(p, cfg, *args, ys.to(dev),
                                                        ys_lens.to(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            cache, steps = None, []
            t0 = time.perf_counter()
            for i in range(1, l + 1):
                out, cache = dec.decoder_forward_one_step(p, cfg, *args, ys[:, :i].to(dev), cache)
                steps.append(out)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            y = dec.moe_ffn(m, x.to(dev), 2)
        return [logits.cpu(), torch.stack(steps, 1).cpu(), cache[-1].cpu(), y.cpu()], fwd_ms, \
            step_ms

    _reset_counts()
    run(torch.device("cuda"))  # warm
    _reset_counts()
    got, fwd_ms, step_ms = run(torch.device("cuda"))
    want, _, _ = run(torch.device("cpu"))
    names = ("forward logits", "one-step log-probs", "last layer's cache", "moe_ffn")
    rel = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    ok = all(r <= ASR_REL_TOL for r in rel) and all(torch.isfinite(g).all() for g in got)
    print("asr decoder: n-best of 10 x 20 tokens over 75 frames: "
          + ", ".join(f"{k} max rel err {r:.2e}" for k, r in zip(names, rel))
          + f" (tol {ASR_REL_TOL:.0e}); batched forward {fwd_ms:.2f} ms, 20 one-step calls "
          f"{step_ms:.1f} ms [{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the ASR decoder on the card disagrees with the CPU")
    _no_launches("asr decoder phase", card)


# ---------------------------------------------------------------------------
# the store of kernel libraries, export, serving under tp, the profile
# ---------------------------------------------------------------------------

STORE_CHILD = r'''
import json, os, sys, time
t_launch = float(sys.argv[1])
sys.path.insert(0, os.getcwd())
import torch
import cosyvoice2_eu_torch as cosy
from cosyvoice2_eu_torch.ops import flash_attention as fa
from cosyvoice2_eu_torch.runtime import aot_cache, model as rt
first = []
tts = rt.TTSModel.tts
def timed(self, *args, **kwargs):
    for chunk in tts(self, *args, **kwargs):
        if not first:
            torch.cuda.synchronize()
            first.append(time.time())
        yield chunk
rt.TTSModel.tts = timed
text = sys.argv[3]
if sys.argv[2] == "warmup":
    import functools
    from cosyvoice2_eu_torch.runtime import warmup
    # its requests as long as the serving process's: len(text) text tokens
    warmup.synthetic_prompt = functools.partial(warmup.synthetic_prompt,
                                                n_text=len(text.encode()))
    warmup.warmup_main(sys.argv[4:])
    out = {}
else:
    import chip_smoke
    cfg = cosy.TTSConfig()
    api = cosy.load(config=cfg, seed=0, download=False)
    fa.flash_attention.launches = 0
    wav, sr = api.tts(text, chip_smoke._prompt(cfg, 3.0))
    out = {"k1": fa.flash_attention.launches, "flows": api._model.timer.counts["flow"],
           "samples": int(wav.size), "tokens": api._model.last_n_tokens,
           "finite": bool(abs(wav).max() > 1e-3 and (wav == wav).all()),
           "nvcc_on_path": __import__("shutil").which("nvcc"),
           "store_stats": aot_cache.store_stats, "store": aot_cache.cache_dir()}
out["first_audio_s"] = first[0] - t_launch
print(json.dumps(out))
'''


STORE_TEXT = "Paris"  # 5 bytes: ~100 tokens a request in both processes


def _store_child(args: list, env: dict, what: str) -> tuple[dict, float]:
    """One fresh process of ``STORE_CHILD``; its last line's JSON (with the
    seconds from its launch to its first audio) and its wall seconds."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", STORE_CHILD, repr(t0), args[0], STORE_TEXT,
                          *args[1:]], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    wall = time.time() - t0
    if res.returncode != 0:
        raise SystemExit(f"store: the {what} process failed ({res.returncode}):\n"
                         f"{res.stdout[-3000:]}{res.stderr[-6000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    if len(lines) > 1:
        out.update(json.loads(lines[-2]))  # warmup_main's line
    return out, wall


def store_path(card: str) -> None:
    """The store of kernel libraries (``runtime/aot_cache.py``) across
    processes, at the published widths.  A process with ``COSY_AOT_CACHE``
    at a fresh directory under ``_build/`` runs ``cosy2-eu warmup
    --export-store DIR --prompt-seconds 3`` (every kernel library built
    there by nvcc, then ``tts`` once without and twice with streaming, each
    request of ``len(STORE_TEXT)`` text tokens); a second fresh process,
    with nvcc hidden (a ``PATH`` without it, ``CUDA_HOME`` at a directory
    that does not exist), loads ``load(seed=0)`` on that store and serves
    one ``Cosy2EU.tts`` of ``STORE_TEXT``.  Gates:
    the first process built every library into the store; the second
    built nothing, found nvcc nowhere, gave finite audio of tokens x 960
    samples, and launched K1 560 times a flow call.  Prints each process's
    seconds from its launch to its first audio, and each library's build or
    load seconds."""
    from cosyvoice2_eu_torch.ops import cuda_build

    store = os.path.join(REPO, "cosyvoice2_eu_torch", "_build", f"store_{os.getpid()}")
    shutil.rmtree(store, ignore_errors=True)
    try:
        env = dict(os.environ, COSY_AOT_CACHE=store)
        cold, cold_wall = _store_child(["warmup", "--export-store", store, "--prompt-seconds",
                                        "3"], env, "warmup")
        built = cold["store_stats"]["built"]
        names = sorted(n for n, _ in built)
        ok = (cold["store"] == store and cold["aot_entries"] == len(cuda_build.SOURCES)
              and len(names) == len(cuda_build.SOURCES)
              and names == sorted(f for f in os.listdir(store) if f.endswith(".so")))
        print(f"store: cosy2-eu warmup into an empty store ({cold['modes']} modes at a 3 s "
              f"prompt): first audio {cold['first_audio_s']:.2f} s after launch, process "
              f"{cold_wall:.2f} s; nvcc built {len(names)} libraries: "
              + ", ".join(f"{n} {s:.2f} s" for n, s in built)
              + f"; store entries {cold['aot_entries']} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("store: the warmup did not build every library into the store")
        nvcc_dirs = {os.path.dirname(p) for p in [shutil.which("nvcc")] if p}
        path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                               if d and os.path.realpath(d) not in
                               {os.path.realpath(x) for x in nvcc_dirs})
        env = dict(os.environ, COSY_AOT_CACHE=store, PATH=path,
                   CUDA_HOME=os.path.join(store, "no_cuda_here"))
        warm, warm_wall = _store_child(["serve"], env, "shipped-store")
        stats = warm["store_stats"]
        want_k1 = _k1_per_flow_default() * warm["flows"]
        ok = (not stats["built"] and warm["nvcc_on_path"] is None and warm["finite"]
              and warm["samples"] == warm["tokens"] * 960 and warm["flows"] > 0
              and warm["k1"] == want_k1 and warm["store"] == store)
        print(f"store: a fresh process on the shipped store, nvcc hidden (on PATH: "
              f"{warm['nvcc_on_path']}): one Cosy2EU.tts of {warm['tokens']} tokens, first "
              f"audio {warm['first_audio_s']:.2f} s after launch (cold start with an empty store "
              f"{cold['first_audio_s']:.2f} s), process {warm_wall:.2f} s; built "
              f"{len(stats['built'])} libraries, loaded "
              + ", ".join(f"{n} {s * 1e3:.2f} ms" for n, s in stats["loaded"])
              + f"; K1 {warm['k1']} (expected {want_k1} = 560 x {warm['flows']} flow calls) "
              f"[{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("store: the process on the shipped store built a library, found "
                             "nvcc, or failed its audio or K1 checks")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _k1_per_flow_default() -> int:
    from cosyvoice2_eu_torch.config import TTSConfig

    return _k1_per_flow(TTSConfig())


EXPORT_BUCKETS = (256,)


def export_path(card: str) -> tuple[list, int]:
    """``export_tts_stages`` of the published-width bf16 flow (``load(seed=0)``)
    at token bucket 256 (mel 512), the program saved, loaded back with
    ``load_exported`` and called on seeded inputs (two rows of 100% and 75%
    of the bucket, t 0.5).  Gates, with the counts set to 0
    before the exported calls and read after: K1 56 times a call (each
    attention of the program one K1 launch, on its bf16 design), and the
    output within K1's bf16 tolerance (2^-7 x max|want|) of the eager
    ``estimator_forward`` on the same inputs (bit-equal is expected).
    Prints the export seconds and the bytes of each ``.pt2``.  Returns K1's
    shapes and launches."""
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.models.estimator import estimator_forward
    from cosyvoice2_eu_torch.runtime.export import export_tts_stages, load_exported

    cfg = TTSConfig()
    tm = cosy.load(config=cfg, seed=0, download=False)._model
    est = tm.params["flow"]["estimator"]
    per_call = _k1_per_flow(cfg) // cfg.flow.cfm.n_timesteps
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes, launches = [], 0
    with tempfile.TemporaryDirectory(prefix="cosy_export_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = export_tts_stages(tm, d, EXPORT_BUCKETS)
        export_s = time.perf_counter() - t0
        sizes = [os.path.getsize(p) for p in paths]
        print(f"export: export_tts_stages at token buckets {EXPORT_BUCKETS} in {export_s:.2f} s: "
              + ", ".join(f"{os.path.basename(p)} {n} bytes" for p, n in zip(paths, sizes))
              + f" [{card}]")
        for path, tok in zip(paths, EXPORT_BUCKETS):
            t = tok * cfg.token_mel_ratio
            c = cfg.flow.output_size
            x, mu, cond = (torch.randn((2, c, t), generator=gen, device="cuda")
                           .to(torch.bfloat16) for _ in range(3))
            lens = [t, 3 * t // 4]
            mask = (torch.arange(t, device="cuda")[None, None, :]
                    < torch.tensor(lens, device="cuda")[:, None, None]).to(torch.bfloat16)
            tt = torch.full((2,), 0.5, device="cuda", dtype=torch.bfloat16)
            spks = torch.randn((2, c), generator=gen, device="cuda").to(torch.bfloat16)
            t0 = time.perf_counter()
            program = load_exported(path)
            load_s = time.perf_counter() - t0
            want = _uncounted(estimator_forward)(est, cfg.flow.estimator, x, mask, mu, tt, spks,
                                                 cond)
            _reset_counts()
            got = program.module()(est, x, mask, mu, tt, spks, cond)
            torch.cuda.synchronize()
            n = _counters()[0].launches
            design = _k1_design()
            err = (got.float() - want.float()).abs().max().item()
            tol = 2.0 ** -7 * want.float().abs().max().item()
            ok = n == per_call and err <= tol and got.shape == want.shape
            print(f"export: {os.path.basename(path)} loaded in {load_s:.2f} s, called at "
                  f"(2, {c}, {t}) bf16: K1 {n} launches (expected {per_call}; {design}), max "
                  f"|exported - eager| {err:.3e} (tol 2^-7 x max|eager| = {tol:.3e}; "
                  f"bit-equal: {bool(torch.equal(got, want))}) [{card}] "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("export: the exported estimator disagrees with the eager one or "
                                 "did not launch K1 once an attention")
            shapes.append((t, lens, 0))
            launches += n
    del tm, est
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, launches


TP_SERVE_TEXTS = ("Bonjour, Paris", "Hallo Welt")
TP_SERVE_GEN = 64


def _tp_serve_model(tp: int):
    """``load(seed=0)``'s weights with the LM in fp32 (fp32 K/V: bf16's
    last-bit drift between the split and the whole sums would split the
    tokens), the flow in bf16 and HiFT in fp32, split over ``tp``."""
    import torch

    import cosyvoice2_eu_torch as cosy
    from cosyvoice2_eu_torch.config import TTSConfig
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm import init_lm
    from cosyvoice2_eu_torch.utils.params import cast_floating

    cfg = TTSConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
              "hift": init_hift(gen, cfg.hift)}
    flow = cast_floating({k: v for k, v in params["flow"].items() if k != "rand_noise"},
                         torch.bfloat16)
    flow["rand_noise"] = params["flow"]["rand_noise"]
    params["flow"] = flow
    return cosy.load(config=cfg, params=params, compute_dtype=None, seed=0, tp=tp,
                     download=False)


def _tp_serve_run(api, follower_delay: float = 0.0) -> dict:
    """One engine (4 slots, 64 generated tokens at most) over ``api``: on a
    server, both requests queued before its loop runs, read until they end;
    on a follower, ``follow`` after ``follower_delay`` s."""
    import threading

    import numpy as np

    from cosyvoice2_eu_torch.serving.engine import TTSEngine

    tm = api._model
    cfg = tm.cfg
    tm.timer.reset()
    calls, shapes = [], []
    _record_flow_calls(tm, calls)
    engine = TTSEngine(tm, n_slots=4, chunk_steps=25, max_cache=1024, max_gen=TP_SERVE_GEN)
    _first_batch_shapes(engine, shapes)
    out = {"role": engine.role}
    if engine.role == "follower":
        time.sleep(follower_delay)
        t0 = time.perf_counter()
        out["steps"] = engine.follow()
        out["follow_s"] = time.perf_counter() - t0
    else:
        if tm.tp_mesh is None:  # queue both before the loop starts, as under tp
            start, engine._ensure_running = engine._ensure_running, lambda: None
        prompt = _prompt(cfg, 3.0)
        handles = [engine.submit(api._frontend.frontend_zero_shot(t, prompt))
                   for t in TP_SERVE_TEXTS]
        if tm.tp_mesh is None:
            start()
        audio = [None] * len(handles)

        def read():
            for i, h in enumerate(handles):
                audio[i] = np.concatenate(list(h))

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(600)
        engine.close()
        if reader.is_alive() or any(a is None for a in audio):
            raise SystemExit("tp serving: a request did not end within 600 s")
        out.update(audio=audio, steps=engine.state.step, tokens=[h._req.harvested for h in handles])
    st = engine.state
    out["slots"] = (st.tokens.cpu().numpy(), st.lengths.cpu().numpy())
    out["decode_s"] = tm.timer.totals.get("eng_decode", 0.0)
    out["k1"] = _counters()[0].launches
    out["flows"] = len(calls) + len(shapes)
    out["shapes"] = shapes + [_k1_shape(cfg, *c[:3]) for c in calls]
    return out


def _rank_tp_serve(rank: int, world: int) -> dict:
    """The tp serving phase on one rank: the tp=2 engine (process 0 serves,
    process 1 follows, starting 2 s late so that process 0 finds both
    requests queued); then, on process 0, the same requests through a
    tp=1 engine over the same weights."""
    import torch

    _reset_counts()
    with torch.no_grad():
        out = {"tp2": _tp_serve_run(_tp_serve_model(world), follower_delay=2.0)}
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            out["tp1"] = _uncounted(_tp_serve_run)(_tp_serve_model(0))
    return out


def tp_serving_path(card: str) -> tuple[list, int]:
    """Serving a tensor-parallel model: 2 ranks share the card over gloo, as
    the parallel phase's (c).  Qwen2-0.5B at its published widths split
    tp=2 (fp32, so fp32 K/V), the flow bf16 and HiFT fp32 whole on each,
    behind a ``TTSEngine`` (4 slots, at most 64 generated tokens) that
    serves 2 concurrent requests of the 3 s prompt from process 0 while
    process 1 follows its LM calls; then the same 2 requests through a
    tp=1 engine on process 0.  Gates: every slot's tokens equal on both
    ranks and at tp=1; process 0's audio within 1e-3 of tp=1's, finite, of
    tokens x 960 samples; the follower ended when process 0 closed; K1 560
    times a flow call on process 0 (its bf16 design), none on process 1.
    Prints ms a 4-row decode step on each rank and at tp=1 (the ranks
    share the card: not a multi-GPU figure).  Returns process 0's K1 shapes
    and launches."""
    import numpy as np

    t0 = time.perf_counter()
    r0, r1 = _run_ranks("tp_serve", PARALLEL_WORLD, 900)
    a, f, ref = r0["tp2"], r1["tp2"], r0["tp1"]
    (tok_a, len_a), (tok_f, len_f), (tok_r, len_r) = a["slots"], f["slots"], ref["slots"]
    same = (np.array_equal(len_a, len_f) and np.array_equal(len_a, len_r)
            and all(np.array_equal(tok_a[s, :n], tok_f[s, :n])
                    and np.array_equal(tok_a[s, :n], tok_r[s, :n]) for s, n in enumerate(len_a)))
    errs = [float(np.abs(x - y).max()) if x.shape == y.shape else float("inf")
            for x, y in zip(a["audio"], ref["audio"])]
    good = all(np.isfinite(x).all() and x.size == n * 960 and float(np.abs(x).max()) > 1e-3
               for x, n in zip(a["audio"], a["tokens"]))
    want_k1 = _k1_per_flow_default() * a["flows"]
    ok = (same and max(errs) <= 1e-3 and good and a["role"] == "server"
          and f["role"] == "follower" and f["steps"] == a["steps"] > 0
          and a["k1"] == want_k1 and f["k1"] == 0)
    ms = lambda r: r["decode_s"] * 1e3 / max(r["steps"], 1)  # noqa: E731
    print(f"tp serving: Qwen2-0.5B fp32 at tp=2 (2 ranks sharing the card over gloo) behind a "
          f"4-slot TTSEngine, 2 concurrent requests of {a['tokens']} tokens: tokens of every slot "
          f"equal on both ranks and at tp=1: {same}; audio max_abs_err vs tp=1 "
          + ", ".join(f"{e:.3e}" for e in errs)
          + f" (tol 1e-3); the follower made {f['steps']} steps and ended on close "
          f"({f['follow_s']:.2f} s); {ms(a):.2f} ms a 4-row step on process 0, {ms(f):.2f} on "
          f"process 1, {ms(ref):.2f} at tp=1 ({a['steps']} steps; not a multi-GPU figure); K1 "
          f"{a['k1']} on process 0 (expected {want_k1} = 560 x {a['flows']} flow calls), "
          f"{f['k1']} on process 1; phase {time.perf_counter() - t0:.1f} s [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("tp serving: the tp=2 engine disagrees with tp=1, or its follower, "
                         "audio or K1 launches failed their checks")
    return a["shapes"], a["k1"]


@_uncounted
def profile_path(card: str) -> float:
    """``tools/profile_stages.py`` at the published widths with ``--trace``:
    each stage's ms, and for one 100-step decode chunk and one flow call
    (token bucket 1024) the card's busy share and the five kernels with
    the most device time.  Gates: every stage timed, each traced block
    with device events and a busy share in (0, 1].  Its launches are a
    measurement's and do not count.  Returns the LM's ms/token."""
    from cosyvoice2_eu_torch.tools import profile_stages

    with tempfile.TemporaryDirectory(prefix="cosy_trace_") as d:
        t0 = time.perf_counter()
        out = profile_stages.run(device="cuda", trace_dir=d,
                                 log=lambda line: print(f"profile: {line} [{card}]"))
        traces = sorted(os.listdir(d))
    ok = (len([k for k in out if k != "trace"]) == 7 and len(traces) == 2
          and all(s["device_events"] > 0 and s["busy_share"] is not None
                  and 0 < s["busy_share"] <= 1 and s["top"] for s in out["trace"].values()))
    print(f"profile: phase {time.perf_counter() - t0:.1f} s, traces {traces}; busy share decode "
          f"{out['trace']['decode']['busy_share']}, flow {out['trace']['flow']['busy_share']} "
          f"[{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("profile: a stage was not timed, or a trace holds no device events")
    return out["lm_decode 100 steps"] / 100


PHASE_SECONDS: dict = {}


# each phase's optimizer on the card, one record a run of the phase: its
# micro-steps and finite emissions (``Optimizer.step`` as counted below) and
# the passes' launches and adoptions over it; "parallel/..." the ranks'
OPTIMIZER_BY_PATH: dict = {}
# the running phase's Optimizer.step calls: on the card, the micro-steps,
# the updates applied and the pass-A launches they make (none at fsdp > 1
# with accum_grad 1); on any device, the trees (flat layouts) first met
_OPTIMIZER_SEEN = [0, 0, 0, 0]


def _count_optimizer_steps() -> None:
    """Count every ``Optimizer.step`` call of this process in
    ``_OPTIMIZER_SEEN``: the optax count the step adds is the update it
    applied, one pass-B launch on the card."""
    from cosyvoice2_eu_torch.train.optim import Optimizer
    from cosyvoice2_eu_torch.utils.params import tree_leaves

    step = Optimizer.step

    @functools.wraps(step)
    def counted(self, params, grads, state):
        trees = len(self._layouts)
        out = step(self, params, grads, state)
        if tree_leaves(grads)[0].is_cuda:
            _OPTIMIZER_SEEN[0] += 1
            _OPTIMIZER_SEEN[1] += out[1]["count"] - state["count"]
            _OPTIMIZER_SEEN[2] += self.mesh is None or self.k > 1
        _OPTIMIZER_SEEN[3] += len(self._layouts) - trees
        return out

    Optimizer.step = counted


def _check_optimizer_launches(name: str) -> None:
    """The passes' launches over phase ``name`` against its optimizer steps
    on the card: one pass A a micro-step, one pass B a finite emission; the
    record kept under ``OPTIMIZER_BY_PATH[name]``."""
    from cosyvoice2_eu_torch.ops import optim_passes as op

    steps, updates, want_a, trees = _OPTIMIZER_SEEN
    got_a, got_b = op.accumulate.launches, op.update.launches
    if not (steps or got_a or got_b):
        return
    OPTIMIZER_BY_PATH.setdefault(name, []).append(
        {"micro_steps": steps, "emissions": updates, "pass_a": got_a, "pass_b": got_b,
         "trees": trees, "adoptions": op.adopt.calls})
    ok = (got_a, got_b) == (want_a, updates)
    print(f"optimizer, {name}: {steps} micro-steps and {updates} finite emissions on the card; "
          f"pass A {got_a} launches (expected {want_a}), pass B {got_b} (expected {updates}); "
          f"{op.adopt.calls} adoptions of {trees} trees met (any device) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the optimizer's passes launched otherwise than its steps ask")


def _summed(records: list) -> dict:
    """The records' counts summed; their times (the ranks'), the largest."""
    return {k: sum(r[k] for r in records) if isinstance(records[0][k], int)
            else max(r[k] for r in records) for k in records[0]}


def _run(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; its host seconds, the card synchronised at its
    end, are added to ``PHASE_SECONDS[name]``.  The optimizer's passes'
    counts are set to 0 before it and checked after it
    (``_check_optimizer_launches``)."""
    import torch

    from cosyvoice2_eu_torch.ops import optim_passes as op

    op.accumulate.launches = op.update.launches = op.adopt.calls = 0
    _OPTIMIZER_SEEN[:] = [0, 0, 0, 0]
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
    _check_optimizer_launches(name)
    return out


def main() -> None:
    import torch

    t_start = time.perf_counter()
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
    from cosyvoice2_eu_torch.runtime.warmup import build_kernels

    _count_optimizer_steps()
    _run("build", build_kernels)  # one nvcc per source, in parallel
    print(f"kernels built in {PHASE_SECONDS['build']:.2f} s")
    for src, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  {src}: {line.strip()}")
    for src in (i8.DECODE_SOURCE, fa.SOURCE, fa.BWD_SOURCE):
        spills = [line.strip() for line in cuda_build.build_logs[src].splitlines()
                  if any(int(b) for b in re.findall(r"(\d+) bytes spill", line))]
        print(f"  {src}: no spills in any of its kernels: {not spills} "
              f"{'ok' if not spills else 'FAIL'}")
        if spills:
            raise SystemExit(f"{src} spills: {spills}")
    for src in (fa.SM90_SOURCE, i8.SM90_SOURCE):
        hgmma = _sass_count(cuda_build.library_path(src), "HGMMA")
        print(f"  {src}: {hgmma} HGMMA (wgmma) instructions in its SASS "
              f"{'ok' if hgmma else 'FAIL'}")
        if not hgmma:
            raise SystemExit(f"{src} holds no wgmma instruction")
    for src in (fa.SOURCE, fa.BWD_SOURCE):
        hmma = _sass_count(cuda_build.library_path(src), "HMMA")
        print(f"  {src}: {hmma} HMMA (mma.sync) instructions in its SASS "
              f"{'ok' if hmma else 'FAIL'}")
        if not hmma:
            raise SystemExit(f"{src} holds no mma.sync instruction")
    _run("occupancy", tf32_occupancy)
    _record_launches(fa)
    _record_k2_launches(i8)

    worst = _run("k1_checks", check_flash_attention)
    worst_dq, worst_dkv = _run("k3k4_checks", check_flash_backward)
    worst_k2 = _run("k2_checks", check_int8_matmul)
    _run("small_tts", check_small_reference)
    _run("small_tts_int8", check_small_reference, lm_quant="int8")
    _run("small_train", check_small_train_reference)
    _run("small_gan", check_small_gan_reference)
    _run("small_stream", check_small_stream)
    _run("small_session", check_small_session)
    _run("small_engine", check_small_engine)
    _run("small_bistream", check_small_bistream)
    _run("small_v1", check_small_v1)
    tts_launches, shapes, flow_ms, bf16_llm = _run("tts", main_path, card)
    if fa.flash_attention_dq.launches or fa.flash_attention_dkv.launches or i8.int8_matmul.launches:
        raise SystemExit("the bf16 TTS path launched a backward kernel or K2")
    decodes, int8_shapes, int8_launches, prefill_ms = _run("int8", int8_path, card, bf16_llm)
    del bf16_llm
    stream_shapes, stream_launches, stream_tokens = _run("stream", stream_path, card)
    int8_stream_shapes, int8_stream_launches, int8_stream_decode, int8_stream_k2 = \
        _run("int8_stream", int8_stream_path, card)
    stream_shapes += int8_stream_shapes
    stream_launches += int8_stream_launches
    # K1 checked against its plain version at every shape the stream phase gave it
    stream_cases = sorted({(tuple(lens), t, chunk) for t, lens, chunk in stream_shapes})
    worst = max(worst, _run("k1_checks", check_flash_attention,
                            [(list(lens), t, (torch.bfloat16,), (chunk,), " stream")
                             for lens, t, chunk in stream_cases]))
    # checkpoint loading, past the largest flow bucket, vc, the prompt
    # frontend: each path read on its own
    new_paths = {"checkpoint": _run("checkpoint", checkpoint_path, card),
                 "long": _run("long", long_path, card),
                 "vc": _run("vc", vc_path, card, stream_tokens),
                 "frontend": _run("frontend", frontend_path, card)}
    # a training run's output served (native checkpoints, the orbax fixture),
    # the ONNX graph executor against the structural conversion, the ASR decoder
    new_paths["native"] = _run("native", native_path, card)
    _run("onnx", onnx_path, card)
    _run("asr_decoder", asr_decoder_path, card)
    # the serving engine (with the HTTP round trip), then tts_batch past 4 HiFT rows
    engine_shapes, engine_launches, engine_decodes, engine_k2 = _run("engine", engine_path, card)
    new_paths["engine"] = (engine_shapes, engine_launches)
    new_paths["tts_batch6"] = _run("tts_batch6", batch6_path, card)
    # bistream (streaming text in), on the default backbone and on Qwen3-0.6B
    bis_shapes, bis_launches, bis_decodes, bis_k2 = _run("bistream", bistream_path, card)
    q3_shapes, q3_launches, q3_decodes, q3_k2 = _run("qwen3", bistream_path, card,
                                                     "hf:Qwen/Qwen3-0.6B")
    new_paths["bistream"] = (bis_shapes, bis_launches)
    new_paths["qwen3"] = (q3_shapes, q3_launches)
    # the evaluation harness over Cosy2EU.tts, SECS on the card's CAM++
    new_paths["eval"] = _run("eval", eval_path, card)
    for name, (shapes_, _) in new_paths.items():
        cases = sorted({(tuple(lens), t, chunk) for t, lens, chunk in shapes_})
        worst = max(worst, _run("k1_checks", check_flash_attention,
                                [(list(lens), t, (torch.bfloat16,), (chunk,), f" {name}")
                                 for lens, t, chunk in cases]))
    # the v1 family at CosyVoice-300M's widths (fp32: K1's fp32 design), then
    # K1 checked at each of its shapes, T and ceil(T / 2) of every flow call
    v1_ts, v1_launches = _run("v1", v1_path, card)
    worst = max(worst, _run("k1_checks", check_flash_attention,
                            [([t, t], t, (torch.float32,), (0,), " v1")
                             for t in sorted({t for t_mel in v1_ts
                                              for t in (t_mel, (t_mel + 1) // 2)})]))
    steps, train_launches = _run("train", train_path, card)
    _run("lm_train", lm_train_path, card)
    _run("gan", gan_path, card)
    cli_steps, cli_k1, cli_cv = _run("cli", cli_path, card)
    # K3/K4 checked against their plain version at every shape the CLI's flow gave them
    cli_cases = sorted({(tuple(r["lens"]), r["chunk"]) for r in cli_steps})
    cli_dq, cli_dkv = _run("k3k4_checks", check_flash_backward,
                           [(list(lens), (torch.float32,), (chunk,)) for lens, chunk in cli_cases])
    # several processes: DP at world 1 on NCCL, DP and --fsdp 2 on 2 ranks,
    # tp=2 decode (the ranks share the card over gloo)
    par = _run("parallel", parallel_path, card)
    # serving a tp=2 model (the same 2 ranks), the exported estimator, the
    # store of kernel libraries across fresh processes, the first trace
    later = {"tp_serving": _run("tp_serving", tp_serving_path, card),
             "export": _run("export", export_path, card)}
    for name, (shapes_, _) in later.items():
        cases = sorted({(tuple(lens), t, chunk) for t, lens, chunk in shapes_})
        worst = max(worst, _run("k1_checks", check_flash_attention,
                                [(list(lens), t, (torch.bfloat16,), (chunk,), f" {name}")
                                 for lens, t, chunk in cases]))
    new_paths.update(later)
    _run("store", store_path, card)
    lm_ms_token = _run("profile", profile_path, card)

    k1_tts, calls_ms = _run("time_k1", time_flash_attention, shapes, tts_launches, card)
    per_call = tts_launches // len(shapes)
    for i, ((t, lens, _), f_ms) in enumerate(zip(shapes, flow_ms)):
        # K1's time at this call's shape, timed alone, times its launches per call
        print(f"request {i}: K1 at T={t}, {lens[0]} frames x {per_call} launches is an estimated "
              f"{per_call * calls_ms[i]:.1f} ms of {f_ms:.1f} ms flow [{card}]")
    k1_int8, _ = _run("time_k1", time_flash_attention, int8_shapes, int8_launches[0], card)
    k1_stream, _ = _run("time_k1", time_flash_attention, stream_shapes, stream_launches, card)
    k1_new = {name: _run("time_k1", time_flash_attention, shapes_, launches_, card)[0]
              for name, (shapes_, launches_) in new_paths.items()}
    # K2 at the int8 path's shapes, the int8 stream's (its prefill at M = 64),
    # the int8 engine's (each prefill_row at M = its bucket, each step at M = 4)
    # and the int8 bistream requests' (extends at M = 64, steps at M = 1; the
    # Qwen3 backbone's at its own (N, K))
    k2_times = _run(
        "time_k2", time_int8_matmul,
        decodes + [int8_stream_decode] + engine_decodes + bis_decodes + q3_decodes
        + par["decodes"],
        int8_launches[3] + int8_stream_k2 + engine_k2 + bis_k2 + q3_k2 + par["k2"], card)
    k2 = _kernel_row("int8_matmul", i8.DECODE_SOURCE, "int8_matmul.py:31", k2_times,
                     bf16_linear_ms=k2_times["bf16_linear_ms"], by_shape=k2_times["by_shape"],
                     by_design=k2_times["by_design"])
    k2["max_abs_err"] = worst_k2
    _print_prefill(k2_times["by_shape"], prefill_ms, card)
    _print_decode_step(k2_times["by_shape"], card)
    k1_fp32, k3, k4, step_kernel_ms = _run(
        "time_fp32", time_training_kernels,
        {"train": (steps, train_launches[0], [CV_SHAPE]), "cli": (cli_steps, cli_k1, cli_cv),
         "parallel": (par["steps"], par["launches"][0], [])},
        card)
    k1_fp32["v1"] = _run("time_fp32", time_v1_flash_attention, v1_ts, card)
    if k1_fp32["v1"]["launches"] != v1_launches:
        raise SystemExit("K1's v1 launches do not match the v1 path's flow calls")
    per_cli = cli_k1 // (len(cli_steps) + len(cli_cv))
    if [k3["launches"], k4["launches"]] != [n + per_cli * len(cli_steps) + p for n, p in
                                            zip(train_launches[1:3], par["launches"][1:])]:
        raise SystemExit("K3/K4 launches do not match the training, command-line and "
                         "parallel paths")
    # K1's times are means per launch over the paths; each path's stand beside them
    paths = {"tts": k1_tts, "int8": k1_int8, "stream": k1_stream, **k1_new, **k1_fp32}
    # eager_ms: the same launches made eagerly from Python, beside the replayed ms
    keys = ("launches", "ms", "eager_ms", "plain_ms", "bound_ms", "fma_bound_ms", "bound_by",
            "library_ms")
    # each design's mean per launch: bf16 (wgmma) on the serving paths, fp32
    # (3xTF32) in training and on the v1 path
    serving = _weighted([(p["launches"], p) for name, p in paths.items() if name not in k1_fp32])
    designs = {"bfloat16": (fa.SM90_SOURCE, serving),
               "float32": (fa.SOURCE, _weighted([(p["launches"], p) for p in k1_fp32.values()]))}
    k1 = _kernel_row("flash_attention_fwd", fa.SM90_SOURCE, "flash_attention.py:71",
                     _weighted([(p["launches"], p) for p in paths.values()]),
                     by_path={name: {k: p[k] for k in keys} for name, p in paths.items()},
                     by_dtype={name: {"source": f"cosyvoice2_eu_torch/csrc/{src}",
                                      **{k: p[k] for k in keys}}
                               for name, (src, p) in designs.items()})
    k1["max_abs_err"], k3["max_abs_err"], k4["max_abs_err"] = \
        worst, max(worst_dq, cli_dq), max(worst_dkv, cli_dkv)
    per_step = train_launches[1] // len(steps)
    for r, kern_ms in zip(steps, step_kernel_ms):
        # K1+K3+K4 at this step's shape and chunk, timed alone, times their launches per step
        print(f"train step {r['step']}: K1+K3+K4 at lengths={r['lens']} chunk={r['chunk']} x "
              f"{per_step} launches is an estimated {per_step * kern_ms:.1f} ms "
              f"({100 * per_step * kern_ms / r['ms']:.0f}%) of {r['ms']:.1f} ms [{card}]")
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s; the LM took "
          f"{lm_ms_token:.2f} ms/token in profile_stages [{card}]")
    opt = _run("optimizer", time_optimizer_passes, card)
    print(json.dumps({"phase_seconds": {k: round(v, 2) for k, v in PHASE_SECONDS.items()}}))
    print(json.dumps({"kernels": [k1, k2, k3, k4, opt]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
