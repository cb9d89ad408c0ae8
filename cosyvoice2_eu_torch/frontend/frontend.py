"""Prompt-side frontend for zero-shot cloning, on a prompt given as artifacts.

Counterpart of the dict-prompt part of ``cosyvoice2_eu_tpu/frontend/frontend.py``:
text tokens, and the zero-shot / cross-lingual packing of a prompt dict
``{"prompt_feat", "speech_tokens", "embedding", "prompt_text"}`` into
``PromptInputs``, and the cached-speaker store (the reference's
``spk2info.pt``).  Prompt feature extraction from a wav (mel, speech
tokenizer, speaker embedding) and text normalisation are not ported yet
(ROADMAP item 5) and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSConfig
from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
from cosyvoice2_eu_torch.runtime.model import PromptInputs


class Frontend:
    def __init__(self, cfg: TTSConfig, tokenizer=None):
        self.cfg = cfg
        self.tokenizer = tokenizer or get_tokenizer("")
        # cached zero-shot speakers: spk_id -> prompt artifact dict
        self.spk_info: dict = {}

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

    # -- cached speakers --------------------------------------------------

    def add_zero_shot_spk(self, spk_id: str, prompt: dict) -> bool:
        self.spk_info[spk_id] = prompt
        return True

    def get_spk(self, spk_id: str) -> dict:
        return self.spk_info[spk_id]

    def save_spk_info(self, path: str) -> None:
        """Write the store as ``.npz``: one array per (speaker, artifact),
        strings stored as 0-d string arrays."""
        flat = {}
        for spk, art in self.spk_info.items():
            for k, v in art.items():
                if isinstance(v, np.ndarray):
                    flat[f"{spk}::{k}"] = v
                else:
                    flat[f"{spk}::{k}::str"] = np.asarray(str(v))
        np.savez(path, **flat)

    def load_spk_info(self, path: str) -> None:
        """Load a store: this package's ``.npz`` or the reference's
        ``spk2info.pt`` (a dict of per-speaker dicts of tensors, its keys
        mapped onto the artifact names)."""
        if path.endswith(".pt"):
            data = torch.load(path, map_location="cpu", weights_only=True)
            names = {"speech_feat": "prompt_feat", "speech_token": "speech_tokens",
                     "llm_embedding": "embedding", "flow_embedding": "embedding"}
            for spk, art in data.items():
                out = {}
                for k, v in art.items():
                    arr = v.numpy() if torch.is_tensor(v) else v
                    key = names.get(k, k)
                    if key in ("speech_tokens", "embedding") and getattr(arr, "ndim", 0) > 1 \
                            and arr.shape[0] == 1:
                        arr = arr.squeeze(0)
                    if key == "prompt_feat" and getattr(arr, "ndim", 0) == 3:
                        arr = arr[0]
                    out[key] = arr
                out.setdefault("prompt_text", "")
                self.spk_info[spk] = out
            return
        with np.load(path, allow_pickle=False) as data:
            for key in data.files:
                parts = key.split("::")
                art = self.spk_info.setdefault(parts[0], {})
                art[parts[1]] = str(data[key]) if len(parts) == 3 else data[key]
