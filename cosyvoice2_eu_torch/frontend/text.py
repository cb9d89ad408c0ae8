"""Multilingual text normalization + sentence packing (host-side).

Re-expression of the reference frontend's FR/DE/EN normalization fallbacks and
token-budget paragraph splitting (reference: cosy_repo/cosyvoice/cli/frontend.py:
64-140 German fallbacks, 380-480 text_normalize;
cosy_repo/cosyvoice/utils/frontend_utils.py:77-199 French rules +
split_paragraph).  Number spelling is native (frontend/numbers.py) instead of
num2words/inflect; language ID is heuristic (the reference's lingua detector is
optional there too).
"""

from __future__ import annotations

import re
from typing import Callable, List


_FRENCH_CHARS = re.compile(r"[àâäéèêëïîôùûüÿç]")
_FRENCH_WORDS = re.compile(
    r"\b(le|la|les|un|une|des|du|de|et|est|avec|dans|pour|sur|par|ce|cette|qui|"
    r"que|dont|où|si|mais|ou|donc|car|ni|or|je|tu|il|elle|nous|vous|ils|elles|"
    r"mon|ma|mes|ton|ta|tes|son|sa|ses|notre|votre|leur|leurs|bonjour|bonsoir|"
    r"merci|salut|français|habite|appelle|travaille)\b",
    re.IGNORECASE,
)
_GERMAN_CHARS = re.compile(r"[äöüÄÖÜß]")
_GERMAN_WORDS = re.compile(
    r"\b(und|oder|nicht|mit|ist|ein|eine|der|die|das|zum|beispiel|bzw|genau|"
    r"genommen|seit|schon|bereits|heute|gestern|morgen|wird|wurden?|kann|"
    r"können|deutsch|ich|sie|wir|ihr|sind|haben|hat|sehr|auch)\b",
    re.IGNORECASE,
)


def detect_language(text: str) -> str:
    """FR/DE/EN language id (per sentence).

    Statistical trigram profiles (frontend/lid.py — the reference's lingua
    analog, frontend.py:297) decide; the keyword/diacritic heuristic below
    is the tie-break for very short inputs where trigram evidence is thin."""
    from cosyvoice2_eu_torch.frontend.lid import detect_language as lid_detect
    from cosyvoice2_eu_torch.frontend.zh import contains_chinese

    if contains_chinese(text):  # reference short-circuit (frontend.py:299)
        return "zh"
    fr_score = (2 if _FRENCH_CHARS.search(text) else 0) + len(_FRENCH_WORDS.findall(text))
    de_score = (2 if _GERMAN_CHARS.search(text) else 0) + len(_GERMAN_WORDS.findall(text))
    if len(text.split()) <= 3:  # too short for stable trigram statistics
        if fr_score > de_score and fr_score >= 1:
            return "fr"
        if de_score > fr_score and de_score >= 1:
            return "de"
    return lid_detect(text)


def remove_bracket(text: str) -> str:
    for ch in ("（", "）", "【", "】", "`"):
        text = text.replace(ch, "")
    return text.replace("——", " ")


# ---------------------------------------------------------------------------
# French
# ---------------------------------------------------------------------------

_FR_ABBREV = [
    (r"\bM\.", "monsieur"),
    (r"\bMme\.?", "madame"),
    (r"\bMlle\.?", "mademoiselle"),
    (r"\bDr\.", "docteur"),
    (r"\bPr\.", "professeur"),
    (r"\bSt\.", "saint"),
    (r"\bCie\.?", "compagnie"),
    (r"\betc\.", "et cetera"),
    (r"\bc-à-d\.?", "c'est-à-dire"),
    (r"\bp\.ex\.", "par exemple"),
    (r"\bav\.", "avenue"),
    (r"\bbd\.?", "boulevard"),
    (r"\bpl\.", "place"),
]

_FR_SYMBOLS = [
    ("&", " et "), ("@", " arobase "), ("%", " pour cent "), ("#", " dièse "),
    ("$", " dollar "), ("€", " euros "), ("£", " livres "), ("°", " degrés "),
    ("+", " plus "), ("=", " égal "),
]


def normalize_french(text: str) -> str:
    from cosyvoice2_eu_torch.frontend.tn import normalize_numbers_dates_units

    for pat, rep in _FR_ABBREV:
        text = re.sub(pat, rep, text, flags=re.IGNORECASE)
    # full semiotic-class cascade (dates, times, currency, decimals,
    # ordinals, units, phone numbers, ranges, cardinals)
    text = normalize_numbers_dates_units(text, "fr")
    for sym, rep in _FR_SYMBOLS:
        text = text.replace(sym, rep)
    text = remove_bracket(text)
    return re.sub(r"\s+", " ", text).strip()


# ---------------------------------------------------------------------------
# German
# ---------------------------------------------------------------------------

_DE_ABBREV = [
    (r"\bz\.?\s?B\.?\b", "zum Beispiel"),
    (r"\bu\.?\s?a\.?\b", "unter anderem"),
    (r"\bbzw\.?\b", "beziehungsweise"),
    (r"\bca\.?\b", "circa"),
    (r"\bd\.?\s?h\.?\b", "das heißt"),
    (r"\binsb\.?\b", "insbesondere"),
    (r"\bNr\.?\b", "Nummer"),
]

def normalize_german(text: str) -> str:
    from cosyvoice2_eu_torch.frontend.tn import normalize_numbers_dates_units

    for pat, rep in _DE_ABBREV:
        text = re.sub(pat, rep, text, flags=re.IGNORECASE)
    text = normalize_numbers_dates_units(text, "de")
    text = text.replace("€", " Euro ").replace("%", " Prozent ")
    text = text.replace("&", " und ").replace("@", " at ").replace("§", " Paragraph ")
    text = text.replace("°C", " Grad Celsius ")
    text = remove_bracket(text)
    return re.sub(r"\s+", " ", text).strip()


def normalize_english(text: str) -> str:
    from cosyvoice2_eu_torch.frontend.tn import normalize_numbers_dates_units

    text = normalize_numbers_dates_units(text, "en")
    text = text.replace("%", " percent ").replace("&", " and ").replace("€", " euros ")
    text = remove_bracket(text)
    return re.sub(r"\s+", " ", text).strip()


def normalize_chinese(text: str) -> str:
    from cosyvoice2_eu_torch.frontend.zh import normalize_chinese as _zh

    return _zh(text)


_NORMALIZERS = {"fr": normalize_french, "de": normalize_german,
                "en": normalize_english, "zh": normalize_chinese}

_SENT_BOUNDARY = re.compile(r"(?<=[.!?;:])\s+")
_ONLY_PUNCT = re.compile(r"^[\s.,!?;:'\"«»()\-–—…]*$")


def is_only_punctuation(text: str) -> bool:
    return bool(_ONLY_PUNCT.match(text))


def split_sentences(text: str) -> List[str]:
    return [s for s in _SENT_BOUNDARY.split(text.strip()) if s]


def pack_segments(
    sentences: List[str],
    token_count: Callable[[str], int],
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
) -> List[str]:
    """Greedy packing of sentences into token-bounded segments
    (reference split_paragraph, frontend_utils.py:137-199)."""
    out: List[str] = []
    cur = ""
    for s in sentences:
        if cur and token_count(cur + " " + s) > token_max_n and token_count(cur) > token_min_n:
            out.append(cur)
            cur = ""
        cur = (cur + " " + s).strip() if cur else s
    if cur:
        if out and token_count(cur) < merge_len:
            out[-1] = out[-1] + " " + cur
        else:
            out.append(cur)
    return out


def text_normalize(
    text: str,
    token_count: Callable[[str], int],
    split: bool = True,
    lang: str | None = None,
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
):
    """Normalize and (optionally) split text into synthesis segments.

    Mirrors CosyVoiceFrontEnd.text_normalize semantics (frontend.py:419):
    per-sentence language detection + normalization, then token-budget packing.
    """
    text = text.strip()
    if not text:
        return [""] if split else ""
    sents = split_sentences(text)
    normalized = []
    for s in sents:
        slang = lang or detect_language(s)
        normalized.append(_NORMALIZERS.get(slang, normalize_english)(s))
    if not split:
        return " ".join(normalized)
    segs = pack_segments(normalized, token_count, token_max_n, token_min_n, merge_len)
    return [s for s in segs if not is_only_punctuation(s)]
