"""The frontend functions that ``load(model_dir=...)`` builds from the
reference's ONNX binaries (``speech_tokenizer_v2.onnx``, ``campplus.onnx``).

Counterpart of ``cosyvoice2_eu_tpu/runtime/onnx_fallback.py``.  The
structural conversion (``runtime/onnx_convert.py``) maps a graph onto the
port's speech tokenizer and CAM++, which run on the device.  A graph of a
topology the converter does not know runs instead through the ONNX graph
executor (``runtime/onnx_exec.run_graph``), with a logged warning, and with
the reference's feed conventions:

  speech tokenizer: feeds[0] = whisper log-mel (1, n_mels, T) float32,
                    feeds[1] = [T] int32; output[0] flattened = codes
                    (frontend.py:262-274)
  campplus:         feeds[0] = kaldi fbank - mean (1, T, 80) float32;
                    output[0] flattened = the x-vector (frontend.py:276-283)

The executor's features and convolutions run on the caller's device, the
rest of the graph in numpy on the host; it is slower than the converted
models, and prompt extraction runs once a prompt.  ``strict=True`` re-raises
the conversion's error instead, and ``COSY2EU_ONNX_EXECUTOR=1`` takes the
executor even where the conversion would succeed.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from cosyvoice2_eu_torch.utils.device import resolve_device


def _first_conv_in_channels(model: dict, ndim: int) -> int | None:
    """In-channel count of the first Conv whose weight is an initializer."""
    init = model["initializers"]
    for n in model["nodes"]:
        if n["op_type"] == "Conv" and len(n["input"]) > 1 and n["input"][1] in init:
            w = np.asarray(init[n["input"][1]])
            if w.ndim == ndim:
                return int(w.shape[1])
    return None


def make_executor_speech_tokenizer_fn(model: dict, device: str | torch.device = "cuda"):
    """16 kHz wav -> FSQ codes by running the parsed ONNX graph itself."""
    from cosyvoice2_eu_torch.frontend.frontend import MAX_PROMPT_SAMPLES_16K, _wav_tensor
    from cosyvoice2_eu_torch.ops.mel import whisper_log_mel
    from cosyvoice2_eu_torch.runtime.onnx_exec import run_graph

    dev = resolve_device(device)
    n_mels = _first_conv_in_channels(model, ndim=3) or 128
    feeds = list(model["inputs"])

    @torch.inference_mode()
    def fn(wav_16k: np.ndarray) -> np.ndarray:
        if len(wav_16k) > MAX_PROMPT_SAMPLES_16K:
            raise ValueError(f"prompt must be <= 30 s, got {len(wav_16k) / 16000:.2f} s")
        mel = whisper_log_mel(_wav_tensor(wav_16k, dev), n_mels=n_mels).cpu().numpy()
        feed = {feeds[0]: mel.astype(np.float32)}
        if len(feeds) > 1:
            feed[feeds[1]] = np.asarray([mel.shape[2]], np.int32)
        codes = run_graph(model, feed, device=dev)[0]
        return np.asarray(codes).reshape(-1).astype(np.int32)

    return fn


def make_executor_spk_embedding_fn(model: dict, feat_dim: int = 80,
                                   device: str | torch.device = "cuda"):
    """16 kHz wav -> x-vector by running the parsed ONNX graph itself."""
    from cosyvoice2_eu_torch.frontend.frontend import _wav_tensor
    from cosyvoice2_eu_torch.models.campplus import kaldi_fbank_cmn
    from cosyvoice2_eu_torch.runtime.onnx_exec import run_graph

    dev = resolve_device(device)
    feeds = list(model["inputs"])

    @torch.inference_mode()
    def fn(wav_16k: np.ndarray) -> np.ndarray:
        fbank = kaldi_fbank_cmn(_wav_tensor(wav_16k, dev), feat_dim).cpu().numpy()
        emb = run_graph(model, {feeds[0]: fbank.astype(np.float32)}, device=dev)[0]
        return np.asarray(emb).reshape(-1).astype(np.float32)

    return fn


def load_frontend_fns(st_path: str | None, cam_path: str | None, strict: bool = False,
                      device: str | torch.device = "cuda"):
    """(speech_tokenizer_fn, spk_embedding_fn) on ``device`` from the ONNX
    files that exist (None for a missing one): the structural conversion
    first; where it raises, the graph executor with a logged warning
    (``strict=True`` re-raises); ``COSY2EU_ONNX_EXECUTOR=1`` takes the
    executor for both."""
    from cosyvoice2_eu_torch.frontend.frontend import (
        make_speech_tokenizer_fn,
        make_spk_embedding_fn,
    )
    from cosyvoice2_eu_torch.runtime.onnx_convert import (
        convert_campplus,
        convert_speech_tokenizer,
    )
    from cosyvoice2_eu_torch.runtime.onnx_import import load_onnx

    force_exec = os.environ.get("COSY2EU_ONNX_EXECUTOR") == "1"
    log = logging.getLogger(__name__)
    fns = []
    for path, convert, make, make_exec in (
            (st_path, convert_speech_tokenizer, make_speech_tokenizer_fn,
             make_executor_speech_tokenizer_fn),
            (cam_path, convert_campplus, make_spk_embedding_fn, make_executor_spk_embedding_fn)):
        if path is None or not os.path.exists(path):
            fns.append(None)
            continue
        graph = load_onnx(path)
        if force_exec:
            fns.append(make_exec(graph, device=device))
            continue
        try:
            params, cfg = convert(graph)
        except Exception:  # any mapping failure: a graph this converter does not know
            if strict:
                raise
            log.warning("structural conversion of %s failed; falling back to the ONNX graph "
                        "executor (slower, topology-agnostic)", path, exc_info=True)
            fns.append(make_exec(graph, device=device))
            continue
        fns.append(make(params, cfg, device=device))
    return tuple(fns)
