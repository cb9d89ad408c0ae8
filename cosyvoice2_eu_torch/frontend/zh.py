"""Minimal native Chinese text normalization.

The reference routes zh sentences to optional heavyweight deps — ttsfrd or
WeTextProcessing (reference: cosy_repo/cosyvoice/cli/frontend.py:344-362) —
and, when neither is installed, returns the sentence UNCHANGED.  This module
is the self-contained analog: Chinese detection, cleanup (corner marks,
brackets, punctuation mapping), and number verbalization (cardinals through
亿, decimals, percent, digit-by-digit years) so zh text degrades gracefully
instead of passing raw digits to the tokenizer.  The EU model itself does not
speak zh; this exists for frontend parity and mixed-text robustness.
"""

from __future__ import annotations

import re

_CJK = re.compile(r"[一-鿿㐀-䶿]")

_DIGITS = "零一二三四五六七八九"
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]  # 10^4 groups through 10^12


def contains_chinese(text: str) -> bool:
    return bool(_CJK.search(text))


def _four_digits_to_words(n: int) -> str:
    """0..9999 -> reading with interior zeros collapsed."""
    if n == 0:
        return ""
    out = []
    pending_zero = False
    for pos in range(3, -1, -1):
        d = (n // 10**pos) % 10
        if d == 0:
            if out:
                pending_zero = True
            continue
        if pending_zero:
            out.append("零")
            pending_zero = False
        out.append(_DIGITS[d] + _UNITS_SMALL[pos])
    return "".join(out)


def number_to_words_zh(n: int) -> str:
    """Cardinal reading through 万亿 (10^12 groups; up to 10^16-1).

    Larger magnitudes fall back to digit-by-digit reading rather than
    emitting groups with missing units (which would silently misread
    the number by factors of 10^4)."""
    if n < 0:
        return "负" + number_to_words_zh(-n)
    if n == 0:
        return "零"
    if n >= 10 ** (4 * len(_UNITS_BIG)):
        return _digits_to_words(str(n))
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out = []
    pending_zero = False
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            # an entirely-zero group still needs the 零 separator before the
            # next non-zero group (一亿零一千, not 一亿一千 which reads 1.1亿)
            pending_zero = bool(out)
            continue
        if out and (pending_zero or g < 1000):
            out.append("零")
        pending_zero = False
        out.append(_four_digits_to_words(g) + _UNITS_BIG[i])
    s = "".join(out)
    # 一十X -> 十X (10..19 idiom)
    if s.startswith("一十"):
        s = s[1:]
    return s


def _digits_to_words(s: str) -> str:
    """Digit-by-digit reading (years, phone numbers)."""
    return "".join(_DIGITS[int(c)] for c in s)


def _verbalize(s: str) -> str:
    if "." in s:
        whole, frac = s.split(".", 1)
        return (number_to_words_zh(int(whole or 0)) + "点"
                + _digits_to_words(frac))
    return number_to_words_zh(int(s))


def normalize_chinese(text: str) -> str:
    """Basic zh TN: cleanup + number verbalization (the reference's zh path
    with neither ttsfrd nor WeTextProcessing available returns `s` as-is —
    this does strictly more)."""
    from .text import remove_bracket

    s = text.replace("\n", " ").strip()
    # corner marks / brackets (frontend_utils replace_corner_mark/remove_bracket)
    s = s.replace("²", "平方").replace("³", "立方")
    s = remove_bracket(s)
    for ch in ("“", "”", "‘", "’"):
        s = s.replace(ch, "")
    # percent before plain numbers: 25% -> 百分之二十五
    s = re.sub(r"(\d+(?:\.\d+)?)\s*[%％]",
               lambda m: "百分之" + _verbalize(m.group(1)), s)
    # years: 2024年 digit-by-digit
    s = re.sub(r"(\d{4})年", lambda m: _digits_to_words(m.group(1)) + "年", s)
    # remaining numbers: cardinal (with decimals)
    s = re.sub(r"\d+(?:\.\d+)?", lambda m: _verbalize(m.group(0)), s)
    # punctuation mapping for zh flow
    s = s.replace(".", "。").replace(" - ", "，")
    s = re.sub(r"[ \t]+", " ", s)
    s = re.sub(r"[，,、]+$", "。", s)
    return s.strip()
