"""Number -> words spelling for FR / DE / EN.

Self-contained replacement for the reference's num2words/inflect dependencies
(reference: cosy_repo/cosyvoice/utils/frontend_utils.py:59-90 and
cosy_repo/cosyvoice/cli/frontend.py:64-140).  Covers cardinals up to the
billions, French 70/80/90 irregulars, German compound one-word numbers, and
ordinals where the TN rules need them (German "1." dates).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# French
# ---------------------------------------------------------------------------

_FR_UNITS = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
]
_FR_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante", 60: "soixante"}


def _fr_below_100(n: int) -> str:
    if n < 17:
        return _FR_UNITS[n]
    if n < 20:
        return "dix-" + _FR_UNITS[n - 10]
    if n < 70:
        tens, unit = (n // 10) * 10, n % 10
        base = _FR_TENS[tens]
        if unit == 0:
            return base
        if unit == 1:
            return base + "-et-un"
        return base + "-" + _FR_UNITS[unit]
    if n < 80:
        if n == 71:
            return "soixante-et-onze"
        return "soixante-" + _fr_below_100(n - 60)
    if n == 80:
        return "quatre-vingts"
    if n < 100:
        return "quatre-vingt-" + _fr_below_100(n - 80)
    raise ValueError(n)


def _fr_below_1000(n: int) -> str:
    if n < 100:
        return _fr_below_100(n)
    hundreds, rest = divmod(n, 100)
    if hundreds == 1:
        head = "cent"
    else:
        head = _FR_UNITS[hundreds] + "-cent" + ("s" if rest == 0 else "")
    return head if rest == 0 else head + "-" + _fr_below_100(rest)


def number_to_words_fr(n: int) -> str:
    if n < 0:
        return "moins " + number_to_words_fr(-n)
    if n < 1000:
        return _fr_below_1000(n)
    parts = []
    for scale, (sing, plur) in (
        (10**9, ("milliard", "milliards")),
        (10**6, ("million", "millions")),
        (10**3, ("mille", "mille")),
    ):
        if n >= scale:
            q, n = divmod(n, scale)
            if scale == 1000 and q == 1:
                parts.append("mille")
            else:
                parts.append(_fr_below_1000(q) + " " + (plur if q > 1 else sing))
    if n:
        parts.append(_fr_below_1000(n))
    return " ".join(parts)


# ---------------------------------------------------------------------------
# German
# ---------------------------------------------------------------------------

_DE_UNITS = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht",
    "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn", "fünfzehn",
    "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_TENS = {
    20: "zwanzig", 30: "dreißig", 40: "vierzig", 50: "fünfzig",
    60: "sechzig", 70: "siebzig", 80: "achtzig", 90: "neunzig",
}
_DE_UNIT_PREFIX = ["", "ein", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht", "neun"]


def _de_below_100(n: int, final: bool = True) -> str:
    if n < 20:
        if n == 1 and not final:
            return "ein"
        return _DE_UNITS[n]
    tens, unit = (n // 10) * 10, n % 10
    if unit == 0:
        return _DE_TENS[tens]
    return _DE_UNIT_PREFIX[unit] + "und" + _DE_TENS[tens]


def _de_below_1000(n: int, final: bool = True) -> str:
    if n < 100:
        return _de_below_100(n, final)
    hundreds, rest = divmod(n, 100)
    head = _DE_UNIT_PREFIX[hundreds] + "hundert"
    return head if rest == 0 else head + _de_below_100(rest, final)


def number_to_words_de(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words_de(-n)
    if n < 1000:
        return _de_below_1000(n)
    parts = []
    for scale, (sing, plur, glue) in (
        (10**9, ("eine Milliarde", "Milliarden", False)),
        (10**6, ("eine Million", "Millionen", False)),
        (10**3, ("eintausend", "tausend", True)),
    ):
        if n >= scale:
            q, n = divmod(n, scale)
            if glue:
                parts.append("eintausend" if q == 1 else _de_below_1000(q, final=False) + "tausend")
            else:
                parts.append(sing if q == 1 else _de_below_1000(q, final=False) + " " + plur)
    if n:
        parts.append(_de_below_1000(n))
    return " ".join(parts)


_DE_ORDINAL_IRREGULAR = {1: "erste", 3: "dritte", 7: "siebte", 8: "achte"}


def ordinal_to_words_de(n: int) -> str:
    if n in _DE_ORDINAL_IRREGULAR:
        return _DE_ORDINAL_IRREGULAR[n]
    base = number_to_words_de(n)
    if n < 20:
        return base + "te"
    return base + "ste"


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

_EN_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = {
    20: "twenty", 30: "thirty", 40: "forty", 50: "fifty",
    60: "sixty", 70: "seventy", 80: "eighty", 90: "ninety",
}


def _en_below_1000(n: int) -> str:
    if n < 20:
        return _EN_UNITS[n]
    if n < 100:
        tens, unit = (n // 10) * 10, n % 10
        return _EN_TENS[tens] + ("-" + _EN_UNITS[unit] if unit else "")
    hundreds, rest = divmod(n, 100)
    head = _EN_UNITS[hundreds] + " hundred"
    return head if rest == 0 else head + " " + _en_below_1000(rest)


def number_to_words_en(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words_en(-n)
    if n < 1000:
        return _en_below_1000(n)
    parts = []
    for scale, name in ((10**9, "billion"), (10**6, "million"), (10**3, "thousand")):
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(_en_below_1000(q) + " " + name)
    if n:
        parts.append(_en_below_1000(n))
    return " ".join(parts)


NUMBER_SPELLERS = {
    "fr": number_to_words_fr,
    "de": number_to_words_de,
    "en": number_to_words_en,
}


def ordinal_to_words_fr(n: int, feminine: bool = False) -> str:
    """French ordinals: premier/première, then cardinal + ième with the
    standard elisions (quatre->quatrième, cinq->cinquième, neuf->neuvième)."""
    if n == 1:
        return "première" if feminine else "premier"
    words = number_to_words_fr(n)
    parts = words.replace("-", " ").split(" ")
    last = parts[-1]
    if last == "un":
        last = "unième"
    elif last == "cinq":
        last = "cinquième"
    elif last == "neuf":
        last = "neuvième"
    elif last.endswith("e"):
        last = last[:-1] + "ième"
    elif last.endswith("s") and n % 10 == 0 and last not in ("trois",):
        last = last[:-1] + "ième"  # vingts -> vingtième is handled below
    else:
        last = last + "ième"
    parts[-1] = last
    return " ".join(parts)


_EN_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def ordinal_to_words_en(n: int) -> str:
    words = number_to_words_en(n)
    parts = words.replace("-", " ").split(" ")
    last = parts[-1]
    if last in _EN_ORD_IRREGULAR:
        last = _EN_ORD_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    parts[-1] = last
    return " ".join(parts)
