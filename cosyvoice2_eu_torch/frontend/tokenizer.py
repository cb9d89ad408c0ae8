"""Qwen text tokenizer wrapper (host-side), the port's own copy.

Counterpart of ``cosyvoice2_eu_tpu/frontend/tokenizer.py``: an HF
AutoTokenizer plus CosyVoice's paralinguistic / control special tokens, the
v1 family's whisper-tiktoken tokenizer (``legacy_tokenizer.py``) over a
``*.tiktoken`` ranks asset, and a deterministic byte-level tokenizer when no
vocabulary is available.
"""

from __future__ import annotations

import logging
import os
from functools import lru_cache
from typing import List

COSYVOICE_SPECIAL_TOKENS = [
    "<|im_start|>", "<|im_end|>", "<|endofprompt|>",
    "[breath]", "<strong>", "</strong>", "[noise]",
    "[laughter]", "[cough]", "[clucking]", "[accent]",
    "[quick_breath]",
    "<laughter>", "</laughter>",
    "[hissing]", "[sigh]", "[vocalized-noise]",
    "[lipsmack]", "[mn]",
]


class QwenTokenizer:
    def __init__(self, token_path: str, skip_special_tokens: bool = True,
                 add_additional_specials: bool | None = None):
        from transformers import AutoTokenizer

        if add_additional_specials is None:
            low = (token_path or "").lower()
            add_additional_specials = (
                token_path == "" or "blanken" in low or "cosyvoice" in low
            )
        self.tokenizer = AutoTokenizer.from_pretrained(token_path)
        if add_additional_specials:
            self.tokenizer.add_special_tokens(
                {
                    "eos_token": "<|endoftext|>",
                    "pad_token": "<|endoftext|>",
                    "additional_special_tokens": COSYVOICE_SPECIAL_TOKENS,
                }
            )
        elif self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token
        self.skip_special_tokens = skip_special_tokens

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.tokenizer([text])["input_ids"][0]

    def decode(self, tokens: List[int]) -> str:
        return self.tokenizer.batch_decode(
            [tokens], skip_special_tokens=self.skip_special_tokens
        )[0]

    def __len__(self) -> int:
        return len(self.tokenizer)


class ByteFallbackTokenizer:
    """UTF-8 byte tokenizer for tests / environments without an HF vocab."""

    def encode(self, text: str, **kwargs) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: List[int]) -> str:
        return bytes(int(t) for t in tokens).decode("utf-8", errors="replace")

    def __len__(self) -> int:
        return 256


@lru_cache(maxsize=None)
def get_tokenizer(token_path: str = "", skip_special_tokens: bool = True):
    """Resolve a tokenizer from a model dir.  A ``*.tiktoken`` ranks asset
    (and no ``tokenizer_config.json``) selects the legacy whisper-tiktoken
    tokenizer, the first such file by name; HF tokenizer files select the
    Qwen tokenizer; an empty path, or a dir with neither, gives the byte
    tokenizer."""
    from cosyvoice2_eu_torch.frontend.legacy_tokenizer import get_legacy_tokenizer

    if not token_path:
        return ByteFallbackTokenizer()
    if os.path.isdir(token_path):
        ranks = sorted(f for f in os.listdir(token_path) if f.endswith(".tiktoken"))
        if ranks and not os.path.exists(os.path.join(token_path, "tokenizer_config.json")):
            return get_legacy_tokenizer(os.path.join(token_path, ranks[0]))
        if not any(
            os.path.exists(os.path.join(token_path, f))
            for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json")
        ):
            logging.warning("no tokenizer files in %s; using byte-fallback tokenizer", token_path)
            return ByteFallbackTokenizer()
    elif token_path.endswith(".tiktoken"):
        return get_legacy_tokenizer(token_path)
    return QwenTokenizer(token_path, skip_special_tokens)
