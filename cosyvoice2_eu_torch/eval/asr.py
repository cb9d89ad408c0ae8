"""ASR hooks for WER evaluation.

The reference transcribes with openai-whisper large-v3 on GPU
(reference: evaluation/metrics_computer.py:104-146).  This environment has no
model weights or egress, so transcription is a pluggable hook: the pipeline
accepts any ``asr(wav, sr) -> text`` callable via ``asr_hook:
"module:function"`` (eval/pipeline.py).

This module ships the standard implementation: a host-side HF whisper wrapper
(on the card unless asked for the CPU) you point at a local checkout of
any Whisper checkpoint (e.g. openai/whisper-large-v3).  Example eval config:

    asr_hook: "cosyvoice2_eu_torch.eval.asr:whisper_from_env"
    device: cuda   # the pipeline binds its device to the hook
    # with WHISPER_DIR=/path/to/whisper-large-v3

or programmatically: ``EvaluationPipeline(..., asr_fn=make_whisper_asr(dir))``.

The PyTorch port's copy of ``cosyvoice2_eu_tpu/eval/asr.py``: it imports
only the port, and gives the same outputs on the same inputs.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import numpy as np


def make_whisper_asr(model_dir: str, language: Optional[str] = None,
                     device: str = "cuda") -> Callable[[np.ndarray, int], str]:
    """asr(wav float32 (T,), sr) -> transcript, via a local HF Whisper dir."""
    import torch
    from transformers import WhisperForConditionalGeneration, WhisperProcessor

    processor = WhisperProcessor.from_pretrained(model_dir)
    model = WhisperForConditionalGeneration.from_pretrained(model_dir).to(device).eval()

    def asr(wav: np.ndarray, sr: int) -> str:
        from cosyvoice2_eu_torch.frontend.frontend import resample

        wav16 = resample(np.asarray(wav, np.float32).reshape(-1), sr, 16000)
        inputs = processor(wav16, sampling_rate=16000, return_tensors="pt")
        kwargs = {}
        if language:
            kwargs["language"] = language
        with torch.inference_mode():
            ids = model.generate(inputs.input_features.to(device), **kwargs)
        return processor.batch_decode(ids, skip_special_tokens=True)[0].strip()

    return asr


@functools.lru_cache(maxsize=2)
def _cached_whisper(device: str):
    model_dir = os.environ.get("WHISPER_DIR")
    if not model_dir or not os.path.isdir(model_dir):
        raise FileNotFoundError(
            "set WHISPER_DIR to a local HF Whisper checkpoint directory "
            "(e.g. a download of openai/whisper-large-v3)"
        )
    return make_whisper_asr(model_dir, language=os.environ.get("WHISPER_LANG"), device=device)


def whisper_from_env(wav: np.ndarray, sr: int, device: str = "cuda") -> str:
    """The asr_hook entry point: lazily builds whisper from $WHISPER_DIR on
    ``device`` (the pipeline binds its own)."""
    return _cached_whisper(device)(wav, sr)
