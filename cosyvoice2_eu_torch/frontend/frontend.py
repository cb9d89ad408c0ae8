"""Prompt-side frontend for zero-shot cloning, on a prompt given as artifacts.

Counterpart of the dict-prompt part of ``cosyvoice2_eu_tpu/frontend/frontend.py``:
text tokens, and the zero-shot / cross-lingual packing of a prompt dict
``{"prompt_feat", "speech_tokens", "embedding", "prompt_text"}`` into
``PromptInputs``.  Prompt feature extraction from a wav (mel, speech
tokenizer, speaker embedding) and text normalisation are not ported yet
(ROADMAP item 5) and raise.
"""

from __future__ import annotations

import numpy as np

from cosyvoice2_eu_torch.config import TTSConfig
from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
from cosyvoice2_eu_torch.runtime.model import PromptInputs


class Frontend:
    def __init__(self, cfg: TTSConfig, tokenizer=None):
        self.cfg = cfg
        self.tokenizer = tokenizer or get_tokenizer("")

    def normalize_text(self, text: str, split: bool = True, lang: str | None = None):
        raise NotImplementedError("text normalisation is not ported yet: ROADMAP item 5")

    def text_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)

    def extract_prompt(self, prompt_wav_16k, prompt_text: str = "", **precomputed) -> dict:
        raise NotImplementedError(
            "prompt extraction from a wav is not ported yet (ROADMAP item 5); pass the "
            "prompt as a dict of artifacts: prompt_feat, speech_tokens, embedding")

    def frontend_zero_shot(self, text: str, prompt: dict) -> PromptInputs:
        """Zero-shot: the prompt transcription conditions the LM."""
        return PromptInputs(
            text_tokens=self.text_tokens(text),
            prompt_text_tokens=self.text_tokens(prompt.get("prompt_text", "") or ""),
            llm_prompt_speech_tokens=prompt["speech_tokens"],
            flow_prompt_speech_tokens=prompt["speech_tokens"],
            prompt_feat=prompt["prompt_feat"],
            embedding=prompt["embedding"],
        )

    def frontend_cross_lingual(self, text: str, prompt: dict) -> PromptInputs:
        """Cross-lingual: drop the prompt text and the LM's prompt speech
        tokens; the flow keeps them for timbre."""
        return PromptInputs(
            text_tokens=self.text_tokens(text),
            prompt_text_tokens=np.zeros((0,), np.int32),
            llm_prompt_speech_tokens=np.zeros((0,), np.int32),
            flow_prompt_speech_tokens=prompt["speech_tokens"],
            prompt_feat=prompt["prompt_feat"],
            embedding=prompt["embedding"],
        )
