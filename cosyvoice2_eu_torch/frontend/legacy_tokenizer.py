"""Legacy whisper-style tiktoken multilingual tokenizer (CosyVoice-300M), the port's own copy.

Counterpart of ``cosyvoice2_eu_tpu/frontend/legacy_tokenizer.py`` (the
reference's tokenizer.py:172-241): the byte-level BPE over a base64 ranks
asset (``*.tiktoken``) and whisper's special tokens (99 language tags, audio
events, emotions, task tokens, 30 reserved specials, the TTS vocal tokens and
1501 timestamps), in pure Python with no tiktoken or whisper dependency.
The ranks asset ships with model checkpoints; pass its path to
:func:`get_legacy_tokenizer`.
"""

from __future__ import annotations

import base64
from typing import Dict, Iterable, List, Optional, Sequence, Union

# Whisper language registry (reference tokenizer.py:14-113 order — the token
# id of <|lang|> depends on this exact ordering).
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
    "minnan": "minnan", "wuyu": "wuyu", "dialect": "dialect",
    "zh/en": "zh/en", "en/zh": "en/zh",
}

AUDIO_EVENT = (
    "ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM", "Laughter",
    "/Laughter", "Applause", "/Applause",
)

EMOTION = ("HAPPY", "SAD", "ANGRY", "NEUTRAL")

TTS_VOCAL_TOKEN = (
    "TTS/B", "TTS/O", "TTS/Q", "TTS/A", "TTS/CO", "TTS/CL", "TTS/H",
    *[f"TTS/SP{i:02d}" for i in range(1, 14)],
)

# tiktoken pat_str from the reference (tokenizer.py:207); needs the `regex`
# module for \p classes (a hard transformers dependency, so always present).
PAT_STR = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
    r"""|\s+(?!\S)|\s+"""
)


def load_ranks(vocab_path: str) -> Dict[bytes, int]:
    """Parse a .tiktoken ranks file: `base64(token) rank` per line."""
    ranks: Dict[bytes, int] = {}
    with open(vocab_path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            token, rank = line.split()
            ranks[base64.b64decode(token)] = int(rank)
    return ranks


def special_token_list(num_languages: int = 99) -> List[str]:
    """The exact special-token order of the reference (tokenizer.py:182-198)."""
    return [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in list(LANGUAGES)[:num_languages]],
        *[f"<|{ev}|>" for ev in AUDIO_EVENT],
        *[f"<|{em}|>" for em in EMOTION],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|SPECIAL_TOKEN_{i}|>" for i in range(1, 31)],
        *[f"<|{tts}|>" for tts in TTS_VOCAL_TOKEN],
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]


def _bpe_encode(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """Greedy lowest-rank pair merging (the tiktoken BPE algorithm)."""
    if piece in ranks:
        return [ranks[piece]]
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts]


class LegacyTokenizer:
    """whisper-tiktoken encoding + minimal whisper-Tokenizer surface.

    Mirrors what the reference actually calls on the wrapped tokenizer:
    ``encode(text, allowed_special=...)`` (dataset/processor.py:244,
    cli/frontend.py:251) and ``decode``; plus the whisper convenience ids
    (sot/eot/language_token/sot_sequence) the 300M-25Hz recipe relies on.
    """

    def __init__(
        self,
        ranks: Dict[bytes, int],
        num_languages: int = 99,
        language: Optional[str] = None,
        task: Optional[str] = None,
    ):
        import regex

        self.ranks = ranks
        self.num_languages = num_languages
        self.language = language
        self.task = task
        n = len(ranks)
        self.special_tokens: Dict[str, int] = {}
        for tok in special_token_list(num_languages):
            self.special_tokens[tok] = n
            n += 1
        self.n_vocab = n
        self._pat = regex.compile(PAT_STR)
        # longest-first alternation so overlapping specials split correctly
        self._special_pat = regex.compile(
            "|".join(
                regex.escape(t)
                for t in sorted(self.special_tokens, key=len, reverse=True)
            )
        )
        self._id_to_bytes: Dict[int, bytes] = {v: k for k, v in ranks.items()}
        self._id_to_special = {v: k for k, v in self.special_tokens.items()}

    # -- core encoding ------------------------------------------------------

    def _encode_ordinary(self, text: str) -> List[int]:
        out: List[int] = []
        for m in self._pat.finditer(text):
            out.extend(_bpe_encode(self.ranks, m.group().encode("utf-8")))
        return out

    def encode(
        self,
        text: str,
        allowed_special: Union[str, Iterable[str]] = "all",
    ) -> List[int]:
        if allowed_special == "all":
            allowed = set(self.special_tokens)
        else:
            allowed = set(allowed_special or ())
        disallowed = [
            m.group()
            for m in self._special_pat.finditer(text)
            if m.group() not in allowed
        ]
        if disallowed:
            raise ValueError(
                f"text contains disallowed special token {disallowed[0]!r}"
            )
        out: List[int] = []
        pos = 0
        for m in self._special_pat.finditer(text):
            out.extend(self._encode_ordinary(text[pos : m.start()]))
            out.append(self.special_tokens[m.group()])
            pos = m.end()
        out.extend(self._encode_ordinary(text[pos:]))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        buf = bytearray()
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                if buf:
                    parts.append(bytes(buf).decode("utf-8", errors="replace"))
                    buf.clear()
                parts.append(self._id_to_special[i])
            else:
                buf.extend(self._id_to_bytes[i])
        if buf:
            parts.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(parts)

    # -- whisper-Tokenizer conveniences --------------------------------------

    @property
    def eot(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    @property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("This tokenizer does not have language token configured")
        return self.special_tokens[f"<|{self.language}|>"]

    @property
    def sot_sequence(self) -> tuple:
        seq = [self.sot]
        if self.language is not None:
            seq.append(self.language_token)
        if self.task is not None:
            seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        return tuple(seq)


def get_legacy_tokenizer(
    vocab_path: str,
    *,
    multilingual: bool = True,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
) -> LegacyTokenizer:
    """Reference ``get_tokenizer`` (tokenizer.py:212-241) over an explicit
    ranks-file path (the asset ships with checkpoints here, not the package)."""
    if multilingual:
        language = (language or "en").lower()
        task = task or "transcribe"
    else:
        language = task = None
    return LegacyTokenizer(
        load_ranks(vocab_path),
        num_languages=num_languages,
        language=language,
        task=task,
    )
