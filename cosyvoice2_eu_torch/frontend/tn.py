"""Rule-based text normalization, WFST-class coverage for FR / DE / EN.

The reference normalizes with NeMo's WFST grammars per language (reference:
cosy_repo/cosyvoice/cli/frontend.py:31-35, 322-338) with regex fallbacks
(frontend.py:64-140, utils/frontend_utils.py:77-135).  This module covers the
same semiotic classes natively — ordered rule passes over each sentence, most
specific first, mirroring a WFST tagger/verbalizer cascade:

  electronic (emails/URLs) > date > time > currency > percent-decimal >
  decimal > fraction > ordinal > roman numeral > measure/unit > phone >
  range > cardinal (grouped, negative) > symbols > abbreviations

Each class is pinned by golden tests (tests/test_tn.py).
"""

from __future__ import annotations

import re
from typing import Callable, List, Tuple

from cosyvoice2_eu_torch.frontend.numbers import (
    number_to_words_de,
    number_to_words_en,
    number_to_words_fr,
    ordinal_to_words_de,
    ordinal_to_words_en,
    ordinal_to_words_fr,
)

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

_ROMAN = {
    "I": 1, "II": 2, "III": 3, "IV": 4, "V": 5, "VI": 6, "VII": 7, "VIII": 8,
    "IX": 9, "X": 10, "XI": 11, "XII": 12, "XIII": 13, "XIV": 14, "XV": 15,
    "XVI": 16, "XVII": 17, "XVIII": 18, "XIX": 19, "XX": 20, "XXI": 21,
}

_MONTHS = {
    "fr": ["janvier", "février", "mars", "avril", "mai", "juin", "juillet",
           "août", "septembre", "octobre", "novembre", "décembre"],
    "de": ["Januar", "Februar", "März", "April", "Mai", "Juni", "Juli",
           "August", "September", "Oktober", "November", "Dezember"],
    "en": ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"],
}

_DIGITS = {
    "fr": ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
           "huit", "neuf"],
    "de": ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
           "acht", "neun"],
    "en": ["zero", "one", "two", "three", "four", "five", "six", "seven",
           "eight", "nine"],
}


def _digits(s: str, lang: str) -> str:
    return " ".join(_DIGITS[lang][int(c)] for c in s if c.isdigit())


def _int_of(s: str) -> int:
    return int(re.sub(r"[.\s ,]", "", s))


Rule = Tuple[re.Pattern, Callable]


def _apply(rules: List[Rule], text: str) -> str:
    for pat, fn in rules:
        text = pat.sub(fn, text)
    return text


# electronic: spell out emails/URLs word-by-word with localized separators
def _electronic(lang: str):
    sep = {
        "fr": {"@": " arobase ", ".": " point ", "/": " slash ", "-": " tiret ",
               "_": " tiret bas ", ":": " deux points "},
        "de": {"@": " at ", ".": " Punkt ", "/": " Schrägstrich ", "-": " Bindestrich ",
               "_": " Unterstrich ", ":": " Doppelpunkt "},
        "en": {"@": " at ", ".": " dot ", "/": " slash ", "-": " dash ",
               "_": " underscore ", ":": " colon "},
    }[lang]

    def verbalize(m):
        out = m.group(0)
        for ch, rep in sep.items():
            out = out.replace(ch, rep)
        return re.sub(r"\s+", " ", out)

    email = re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]+\b")
    url = re.compile(r"\b(?:https?://|www\.)\S+\b")
    return [(email, verbalize), (url, verbalize)]


# ---------------------------------------------------------------------------
# French
# ---------------------------------------------------------------------------

_FR_CURRENCIES = {"€": ("euro", "euros"), "$": ("dollar", "dollars"),
                  "£": ("livre", "livres"), "CHF": ("franc suisse", "francs suisses")}
_FR_UNITS = {
    "km": ("kilomètre", "kilomètres"), "m": ("mètre", "mètres"),
    "cm": ("centimètre", "centimètres"), "mm": ("millimètre", "millimètres"),
    "kg": ("kilogramme", "kilogrammes"), "g": ("gramme", "grammes"),
    "l": ("litre", "litres"), "ml": ("millilitre", "millilitres"),
    "km/h": ("kilomètre heure", "kilomètres heure"),
    "m²": ("mètre carré", "mètres carrés"), "°c": ("degré Celsius", "degrés Celsius"),
    "min": ("minute", "minutes"), "sec": ("seconde", "secondes"),
    "ghz": ("gigahertz", "gigahertz"), "mhz": ("mégahertz", "mégahertz"),
    "go": ("gigaoctet", "gigaoctets"), "mo": ("mégaoctet", "mégaoctets"),
}
_FR_FRACTIONS = {(1, 2): "un demi", (1, 3): "un tiers", (2, 3): "deux tiers",
                 (1, 4): "un quart", (3, 4): "trois quarts"}


def _fr_amount(n_int: int, cents: str | None, unit_s: str, unit_p: str) -> str:
    out = number_to_words_fr(n_int) + " " + (unit_p if n_int > 1 else unit_s)
    if cents and int(cents) > 0:
        out += " " + number_to_words_fr(int(cents))
    return out


def fr_rules() -> List[Rule]:
    w = number_to_words_fr
    rules: List[Rule] = []
    rules += _electronic("fr")
    # date 12/03/2024 or 12/03
    def date(m):
        d, mo = int(m.group(1)), int(m.group(2))
        if not (1 <= mo <= 12 and 1 <= d <= 31):
            return m.group(0)
        day = "premier" if d == 1 else w(d)
        out = f"{day} {_MONTHS['fr'][mo - 1]}"
        if m.group(3):
            out += " " + w(int(m.group(3)))
        return out

    rules.append((re.compile(r"\b(\d{1,2})/(\d{1,2})/(\d{4})\b"), date))
    # time 14h30 / 14h / 14:30
    def time(m):
        hh, mm = int(m.group(1)), m.group(2)
        out = ("une heure" if hh == 1 else w(hh) + " heures")
        if mm and int(mm) > 0:
            out += " " + w(int(mm))
        return out

    rules.append((re.compile(r"\b(\d{1,2})\s?h\s?(\d{2})?\b"), time))
    rules.append((re.compile(r"\b(\d{1,2}):(\d{2})\b"), time))
    # currency: 12,50 € | €12.50 | 15 €
    def cur(m):
        amount = m.group("a").replace(",", ".")
        sym = m.group("c")
        sing, plur = _FR_CURRENCIES[sym]
        intp, _, frac = amount.partition(".")
        return _fr_amount(_int_of(intp), frac or None, sing, plur)

    sym = "|".join(re.escape(s) for s in _FR_CURRENCIES)
    rules.append((re.compile(rf"(?P<a>\d[\d\s .]*(?:,\d+)?)\s?(?P<c>{sym})"), cur))
    rules.append((re.compile(rf"(?P<c>{sym})\s?(?P<a>\d+(?:[.,]\d+)?)"), cur))
    # units accept decimals ("3,5 km") and run before the decimal rule
    def unit(m):
        amount = m.group(1).strip()
        u = m.group(2).lower()
        sing, plur = _FR_UNITS[u]
        if "," in amount:
            return _fr_decimal_words(amount) + " " + plur
        n = _int_of(amount)
        return w(n) + " " + (plur if n > 1 else sing)

    unit_pat = "|".join(re.escape(u) for u in sorted(_FR_UNITS, key=len, reverse=True))
    rules.append((re.compile(rf"\b(\d[\d\s .]*(?:,\d+)?)\s?({unit_pat})\b", re.IGNORECASE), unit))
    # percent (incl. decimal)
    def pct(m):
        return _fr_decimal_words(m.group(1)) + " pour cent"

    rules.append((re.compile(r"\b(\d+(?:,\d+)?)\s?%"), pct))
    # decimal 3,14
    rules.append((re.compile(r"\b\d+,\d+\b"), lambda m: _fr_decimal_words(m.group(0))))
    # fractions
    def frac(m):
        a, b = int(m.group(1)), int(m.group(2))
        if (a, b) in _FR_FRACTIONS:
            return _FR_FRACTIONS[(a, b)]
        return f"{w(a)} sur {w(b)}"

    rules.append((re.compile(r"\b(\d+)/(\d+)\b"), frac))
    # ordinals 1er 1re 1ère 2e 2ème 3èmes
    def ordinal(m):
        n = int(m.group(1))
        suf = m.group(2).lower()
        fem = suf in ("re", "ère", "res", "ères")
        return ordinal_to_words_fr(n, feminine=fem)

    rules.append((re.compile(r"\b(\d+)\s?(er|ère|ere|re|res|ères|èmes?|emes?|e)\b"), ordinal))
    # roman ordinals: XVe siècle / XIXème
    def roman_ord(m):
        val = _ROMAN.get(m.group(1))
        return ordinal_to_words_fr(val) if val else m.group(0)

    rules.append((re.compile(r"\b(X{0,3}I?[VX]?I{0,3})\s?(?:e|ème|eme)\b(?=\s*siècle)"), roman_ord))
    # regnal roman numerals: Louis XIV -> Louis quatorze (I -> premier)
    def regnal(m):
        name, num = m.group(1), m.group(2)
        val = _ROMAN.get(num)
        if val is None:
            return m.group(0)
        return f"{name} {'premier' if val == 1 else w(val)}"

    rules.append((re.compile(r"\b([A-ZÉÈ][a-zéèêëïî]+)\s+(X{0,3}(?:IX|IV|V?I{0,3}))\b(?![\w./-])"), regnal))
    # units: 5 km, 12 kg ...
    def unit(m):
        n = _int_of(m.group(1))
        u = m.group(2).lower()
        sing, plur = _FR_UNITS[u]
        return w(n) + " " + (plur if n > 1 else sing)

    unit_pat = "|".join(re.escape(u) for u in sorted(_FR_UNITS, key=len, reverse=True))
    rules.append((re.compile(rf"\b(\d[\d\s .]*)\s?({unit_pat})\b", re.IGNORECASE), unit))
    # phone: groups of 2 digits x5 (French style)
    def phone(m):
        pairs = re.findall(r"\d{2}", m.group(0).replace(" ", "").replace(".", ""))
        return " ".join(
            _digits(p, "fr") if p[0] == "0" else w(int(p)) for p in pairs
        )

    rules.append((re.compile(r"\b0\d(?:[\s.]\d{2}){4}\b"), phone))
    # ranges 10-20
    rules.append((re.compile(r"\b(\d+)\s?[-–]\s?(\d+)\b"),
                  lambda m: f"{w(int(m.group(1)))} à {w(int(m.group(2)))}"))
    # grouped thousands 1 234 567 / 1.234.567 then plain integers (negatives)
    rules.append((re.compile(r"(?<![\w,])[-−]?\d{1,3}(?:[\s .]\d{3})+(?!\d)"),
                  lambda m: w(_int_of(m.group(0).replace("−", "-")))))
    rules.append((re.compile(r"(?<![\w,])[-−]\d+\b"),
                  lambda m: "moins " + w(int(m.group(0).lstrip("-−")))))
    rules.append((re.compile(r"\b\d+\b"), lambda m: w(int(m.group(0)))))
    return rules


def _fr_decimal_words(s: str) -> str:
    intp, _, frac = s.replace(".", ",").partition(",")
    out = number_to_words_fr(_int_of(intp))
    if frac:
        out += " virgule " + _digits(frac, "fr")
    return out


# ---------------------------------------------------------------------------
# German
# ---------------------------------------------------------------------------

_DE_CURRENCIES = {"€": "Euro", "$": "Dollar", "£": "Pfund", "CHF": "Franken"}
_DE_UNITS = {
    "km": "Kilometer", "m": "Meter", "cm": "Zentimeter", "mm": "Millimeter",
    "kg": "Kilogramm", "g": "Gramm", "l": "Liter", "ml": "Milliliter",
    "km/h": "Kilometer pro Stunde", "m²": "Quadratmeter",
    "°c": "Grad Celsius", "min": "Minuten", "s": "Sekunden",
    "ghz": "Gigahertz", "mhz": "Megahertz", "gb": "Gigabyte", "mb": "Megabyte",
}
_DE_FRACTIONS = {(1, 2): "ein halb", (1, 3): "ein Drittel", (2, 3): "zwei Drittel",
                 (1, 4): "ein Viertel", (3, 4): "drei Viertel"}


def de_rules() -> List[Rule]:
    w = number_to_words_de
    rules: List[Rule] = []
    rules += _electronic("de")
    # date 12.03.2024 / 12.03. -> ordinal day + month
    def date(m):
        d, mo = int(m.group(1)), int(m.group(2))
        if not (1 <= mo <= 12 and 1 <= d <= 31):
            return m.group(0)
        out = f"{ordinal_to_words_de(d)} {_MONTHS['de'][mo - 1]}"
        if m.group(3):
            out += " " + w(int(m.group(3)))
        return out

    rules.append((re.compile(r"\b(\d{1,2})\.(\d{1,2})\.(\d{4})?\b"), date))
    # time 14:30 (Uhr)
    def time(m):
        out = w(int(m.group(1))) + " Uhr"
        if int(m.group(2)) > 0:
            out += " " + w(int(m.group(2)))
        return out

    rules.append((re.compile(r"\b(\d{1,2}):(\d{2})(?:\s?Uhr)?\b"), time))
    rules.append((re.compile(r"\b(\d{1,2})\s?Uhr\b"), lambda m: w(int(m.group(1))) + " Uhr"))
    # currency 12,50 € / €12,50
    def cur(m):
        name = _DE_CURRENCIES[m.group("c")]
        amount = m.group("a")
        intp, _, frac = amount.partition(",")
        out = w(_int_of(intp)) + " " + name
        if frac and int(frac) > 0:
            out += " " + w(int(frac))
        return out

    sym = "|".join(re.escape(s) for s in _DE_CURRENCIES)
    rules.append((re.compile(rf"(?P<a>\d[\d.\s ]*(?:,\d+)?)\s?(?P<c>{sym})"), cur))
    rules.append((re.compile(rf"(?P<c>{sym})\s?(?P<a>\d+(?:,\d+)?)"), cur))
    # units accept decimals and run before the decimal rule
    def unit(m):
        amount = m.group(1).strip()
        name = _DE_UNITS[m.group(2).lower()]
        if "," in amount:
            return _de_decimal_words(amount) + " " + name
        return w(_int_of(amount)) + " " + name

    unit_pat = "|".join(re.escape(u) for u in sorted(_DE_UNITS, key=len, reverse=True))
    rules.append((re.compile(rf"\b(\d[\d.\s ]*(?:,\d+)?)\s?({unit_pat})\b", re.IGNORECASE), unit))
    # percent
    rules.append((re.compile(r"\b(\d+(?:,\d+)?)\s?%"),
                  lambda m: _de_decimal_words(m.group(1)) + " Prozent"))
    # decimal
    rules.append((re.compile(r"\b\d{1,3}(?:[.\s ]\d{3})*,\d+\b"),
                  lambda m: _de_decimal_words(m.group(0))))
    # fractions
    def frac(m):
        a, b = int(m.group(1)), int(m.group(2))
        return _DE_FRACTIONS.get((a, b), f"{w(a)} durch {w(b)}")

    rules.append((re.compile(r"\b(\d+)/(\d+)\b"), frac))
    # ordinals "3." (before nouns / end)
    rules.append((re.compile(r"\b(\d{1,3})\.(?=\s|$)"),
                  lambda m: ordinal_to_words_de(int(m.group(1)))))
    # units
    def unit(m):
        return w(_int_of(m.group(1))) + " " + _DE_UNITS[m.group(2).lower()]

    unit_pat = "|".join(re.escape(u) for u in sorted(_DE_UNITS, key=len, reverse=True))
    rules.append((re.compile(rf"\b(\d[\d.\s ]*)\s?({unit_pat})\b", re.IGNORECASE), unit))
    # ranges
    rules.append((re.compile(r"\b(\d+)\s?[-–]\s?(\d+)\b"),
                  lambda m: f"{w(int(m.group(1)))} bis {w(int(m.group(2)))}"))
    # grouped thousands + integers + negatives
    rules.append((re.compile(r"(?<![\w,])[-−]?\d{1,3}(?:[.\s ]\d{3})+(?!\d)"),
                  lambda m: w(_int_of(m.group(0).replace("−", "-")))))
    rules.append((re.compile(r"(?<![\w,])[-−]\d+\b"),
                  lambda m: "minus " + w(int(m.group(0).lstrip("-−")))))
    rules.append((re.compile(r"\b\d+\b"), lambda m: w(int(m.group(0)))))
    return rules


def _de_decimal_words(s: str) -> str:
    intp, _, frac = s.partition(",")
    out = number_to_words_de(_int_of(intp))
    if frac:
        out += " Komma " + _digits(frac, "de")
    return out


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

_EN_CURRENCIES = {"$": ("dollar", "dollars", "cent", "cents"),
                  "€": ("euro", "euros", "cent", "cents"),
                  "£": ("pound", "pounds", "penny", "pence")}
_EN_UNITS = {
    "km": "kilometers", "m": "meters", "cm": "centimeters", "kg": "kilograms",
    "g": "grams", "mph": "miles per hour", "km/h": "kilometers per hour",
    "°c": "degrees Celsius", "°f": "degrees Fahrenheit", "min": "minutes",
    "ghz": "gigahertz", "gb": "gigabytes", "mb": "megabytes",
}


def en_rules() -> List[Rule]:
    w = number_to_words_en
    rules: List[Rule] = []
    rules += _electronic("en")
    # time 14:30
    def time(m):
        hh, mm = int(m.group(1)), int(m.group(2))
        return w(hh) + (" o'clock" if mm == 0 else " " + w(mm))

    rules.append((re.compile(r"\b(\d{1,2}):(\d{2})\b"), time))
    # currency $12.50
    def cur(m):
        sing, plur, csing, cplur = _EN_CURRENCIES[m.group("c")]
        intp, _, frac = m.group("a").partition(".")
        n = _int_of(intp)
        out = w(n) + " " + (sing if n == 1 else plur)
        if frac and int(frac) > 0:
            c = int(frac)
            out += " " + w(c) + " " + (csing if c == 1 else cplur)
        return out

    sym = "|".join(re.escape(s) for s in _EN_CURRENCIES)
    rules.append((re.compile(rf"(?P<c>{sym})\s?(?P<a>\d[\d,]*(?:\.\d+)?)"), cur))
    rules.append((re.compile(rf"(?P<a>\d[\d,]*(?:\.\d+)?)\s?(?P<c>{sym})"), cur))
    # percent / decimal
    def dec(s):
        intp, _, frac = s.partition(".")
        out = w(_int_of(intp))
        if frac:
            out += " point " + _digits(frac, "en")
        return out

    def unit(m):
        amount = m.group(1)
        return dec(amount) + " " + _EN_UNITS[m.group(2).lower()]

    unit_pat = "|".join(re.escape(u) for u in sorted(_EN_UNITS, key=len, reverse=True))
    rules.append((re.compile(rf"\b(\d[\d,]*(?:\.\d+)?)\s?({unit_pat})\b", re.IGNORECASE), unit))
    rules.append((re.compile(r"\b(\d+(?:\.\d+)?)\s?%"), lambda m: dec(m.group(1)) + " percent"))
    rules.append((re.compile(r"\b\d+\.\d+\b"), lambda m: dec(m.group(0))))
    # ordinals 1st 2nd 3rd 4th
    rules.append((re.compile(r"\b(\d+)\s?(?:st|nd|rd|th)\b"),
                  lambda m: ordinal_to_words_en(int(m.group(1)))))
    # ranges
    rules.append((re.compile(r"\b(\d+)\s?[-–]\s?(\d+)\b"),
                  lambda m: f"{w(int(m.group(1)))} to {w(int(m.group(2)))}"))
    # grouped thousands 1,234,567 + integers + negatives
    rules.append((re.compile(r"(?<![\w.])\d{1,3}(?:,\d{3})+(?!\d)"),
                  lambda m: w(_int_of(m.group(0)))))
    rules.append((re.compile(r"(?<![\w.])[-−]\d+\b"),
                  lambda m: "minus " + w(int(m.group(0).lstrip("-−")))))
    rules.append((re.compile(r"\b\d+\b"), lambda m: w(int(m.group(0)))))
    return rules


_RULES = {"fr": fr_rules, "de": de_rules, "en": en_rules}
_CACHE: dict = {}


def normalize_numbers_dates_units(text: str, lang: str) -> str:
    """Run the full semiotic-class cascade for one language."""
    if lang not in _CACHE:
        _CACHE[lang] = _RULES.get(lang, en_rules)()
    return _apply(_CACHE[lang], text)
