"""The port's own copy of the text side (``frontend/text.py``, ``tn.py``,
``numbers.py``, ``lid.py``, ``zh.py``) against the JAX package's, string for
string, on the golden tables of ``tests/test_tn.py`` and mixed paragraphs;
and ``Frontend.normalize_text`` against the JAX frontend's."""

import pytest
from test_tn import DE_CASES, EN_CASES, FR_CASES

from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.frontend import lid as port_lid
from cosyvoice2_eu_torch.frontend import numbers as port_numbers
from cosyvoice2_eu_torch.frontend import text as port_text
from cosyvoice2_eu_torch.frontend import zh as port_zh
from cosyvoice2_eu_torch.frontend.frontend import Frontend
from cosyvoice2_eu_torch.frontend.tn import normalize_numbers_dates_units as port_tn
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.frontend import lid as jax_lid
from cosyvoice2_eu_tpu.frontend import numbers as jax_numbers
from cosyvoice2_eu_tpu.frontend import text as jax_text
from cosyvoice2_eu_tpu.frontend import zh as jax_zh
from cosyvoice2_eu_tpu.frontend.frontend import Frontend as JaxFrontend
from cosyvoice2_eu_tpu.frontend.tn import normalize_numbers_dates_units as jax_tn

TN_CASES = [(src, lang) for lang, table in (("fr", FR_CASES), ("de", DE_CASES),
                                             ("en", EN_CASES)) for src, _ in table]

PARAGRAPHS = [
    "Bonjour ! Le 12/03/2024 à 14h30, M. Dupont a payé 1 234,56 € pour 3,5 km de câble. "
    "Merci beaucoup.",
    "Guten Morgen. Am 12.03.2024 um 14:30 Uhr zahlte Dr. Meier 12,50 €, z.B. für 3 kg Äpfel. "
    "Das ist 50 % mehr als 1995.",
    "Hello there. It costs $12.50 on the 3rd, about 3.5 % more; call me at 14:30.",
    "Je ne sais pas. Das weiß ich nicht. I don't know about that. 你好，世界。",
    "今年是2024年，增长25%，价格3.5元. Et en France ? Ça coûte 15 €!",
    "Visit www.example.com now! Écrivez à test@example.com ; info@firma.de.",
    "Au XVe siècle, Louis XIV régnait. Der 3. Versuch war am 1. Mai. The 21st day.",
    "   ",
    "!!! ... ???",
]

SENTENCES = [s for p in PARAGRAPHS for s in jax_text.split_sentences(p)] + [
    "Je ne sais pas", "Das weiß ich nicht", "merci beaucoup", "vielen dank", "Straße",
    "ça va", "xq zz", "a good idea for tomorrow", "这是 2024 年的测试"]


@pytest.mark.parametrize("src,lang", TN_CASES)
def test_tn_cascade_equals_jax(src, lang):
    assert port_tn(src, lang) == jax_tn(src, lang)


@pytest.mark.parametrize("lang", ["fr", "de", "en", "zh"])
@pytest.mark.parametrize("para", range(len(PARAGRAPHS)))
def test_language_normalizers_equal_jax(lang, para):
    assert port_text._NORMALIZERS[lang](PARAGRAPHS[para]) == \
        jax_text._NORMALIZERS[lang](PARAGRAPHS[para])


@pytest.mark.parametrize("sent", range(len(SENTENCES)))
def test_detect_language_equals_jax(sent):
    s = SENTENCES[sent]
    assert port_text.detect_language(s) == jax_text.detect_language(s)
    assert port_lid.detect_language(s) == jax_lid.detect_language(s)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("para", range(len(PARAGRAPHS)))
def test_text_normalize_equals_jax(para, split):
    """Per-sentence language id, normalisation and token-budget packing with
    one token counter (characters), small budgets so that packing splits."""
    kw = dict(split=split, token_max_n=24, token_min_n=12, merge_len=6)
    assert port_text.text_normalize(PARAGRAPHS[para], len, **kw) == \
        jax_text.text_normalize(PARAGRAPHS[para], len, **kw)


@pytest.mark.parametrize("para", range(len(PARAGRAPHS)))
def test_frontend_normalize_text_equals_jax(para):
    """``Frontend.normalize_text`` counts tokens with its tokenizer (the byte
    tokenizer here), with and without a forced language."""
    port_fe, jax_fe = Frontend(port_tiny(), device="cpu"), JaxFrontend(tiny_test_config())
    for lang in (None, "fr"):
        assert port_fe.normalize_text(PARAGRAPHS[para], lang=lang) == \
            jax_fe.normalize_text(PARAGRAPHS[para], lang=lang)


@pytest.mark.parametrize("n", [0, 1, 16, 17, 21, 71, 80, 91, 99, 101, 200, 1001, 1995, 2024,
                               80_000, 1_000_000, 123_456_789, 10**9 + 1])
def test_number_words_equal_jax(n):
    for name in ("number_to_words_fr", "number_to_words_de", "number_to_words_en"):
        assert getattr(port_numbers, name)(n) == getattr(jax_numbers, name)(n)
    if n < 10**6:
        for name in ("ordinal_to_words_fr", "ordinal_to_words_de", "ordinal_to_words_en"):
            if n:
                assert getattr(port_numbers, name)(n) == getattr(jax_numbers, name)(n)
    assert port_zh.number_to_words_zh(n) == jax_zh.number_to_words_zh(n)
