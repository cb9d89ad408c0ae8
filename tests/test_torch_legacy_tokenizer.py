"""The port's whisper-tiktoken tokenizer (``frontend/legacy_tokenizer.py``)
and its resolution by ``get_tokenizer`` against the JAX package's, on
synthetic ranks written as ``tests/test_legacy_tokenizer.py`` writes them:
equal ids and decodes.  Parity with tiktoken over the real ranks asset
waits for that asset."""

import base64

import pytest

from cosyvoice2_eu_torch.frontend import legacy_tokenizer as port_lt
from cosyvoice2_eu_torch.frontend import tokenizer as port_tok
from cosyvoice2_eu_tpu.frontend import legacy_tokenizer as jax_lt
from cosyvoice2_eu_tpu.frontend import tokenizer as jax_tok

TEXTS = [
    "<|startoftranscript|><|en|> hello<|endoftext|>",
    "héllo wörld ÷ 测试 🚀",
    "Bonjour tout le monde, il est 14h30.",
    "mixed 混合 text with  spaces\n\nand\tlines 123,456.78",
    " hello hello  he llo",
]


def _ranks():
    ranks = {bytes([b]): b for b in range(256)}
    for i, tok in enumerate((b" he", b"llo", b" hello", b"ll", b"ab", b"abc", b"bc")):
        ranks[tok] = 256 + i
    return ranks


def test_bpe_merge_order_matches_jax():
    """Greedy lowest-rank merging: a whole token, ab then abc, bc, none."""
    ranks = _ranks()
    for piece, want in ((b"abc", [ranks[b"abc"]]), (b"abcd", [ranks[b"abc"], ord("d")]),
                        (b"bcd", [ranks[b"bc"], ord("d")]), (b"xyz", list(b"xyz")),
                        (b" hello", [ranks[b" hello"]]), (b"hello", [ord("h"), ord("e"),
                                                                     ranks[b"llo"]])):
        assert port_lt._bpe_encode(ranks, piece) == jax_lt._bpe_encode(ranks, piece) == want


def test_specials_split_and_round_trip_match_jax():
    ours = port_lt.LegacyTokenizer(_ranks(), num_languages=3)
    theirs = jax_lt.LegacyTokenizer(_ranks(), num_languages=3)
    for text in TEXTS:
        ids = ours.encode(text, allowed_special="all")
        assert ids == theirs.encode(text, allowed_special="all"), text
        assert ours.decode(ids) == theirs.decode(ids) == text
    ids = ours.encode(TEXTS[0])
    assert ids[0] == ours.sot and ids[-1] == ours.eot
    assert ours.special_tokens["<|en|>"] in ids
    assert (ours.n_vocab, ours.sot, ours.eot, ours.transcribe, ours.translate,
            ours.no_timestamps) == (theirs.n_vocab, theirs.sot, theirs.eot, theirs.transcribe,
                                    theirs.translate, theirs.no_timestamps)


def test_disallowed_special_raises_like_jax():
    for mod in (port_lt, jax_lt):
        tok = mod.LegacyTokenizer(_ranks(), num_languages=3)
        with pytest.raises(ValueError, match="disallowed special"):
            tok.encode("x <|endoftext|> y", allowed_special=())
        assert tok.encode("x <|endoftext|>", allowed_special={"<|endoftext|>"})[-1] == tok.eot


def test_special_token_layout_matches_jax():
    specials = port_lt.special_token_list(99)
    assert specials == jax_lt.special_token_list(99)
    assert specials[:3] == ["<|endoftext|>", "<|startoftranscript|>", "<|en|>"]
    assert "<|SPECIAL_TOKEN_30|>" in specials and specials[-1] == "<|30.00|>"
    assert specials.count("<|0.00|>") == 1
    assert len([s for s in specials if s.startswith("<|TTS/")]) == 20
    assert port_lt.special_token_list(3) == jax_lt.special_token_list(3)


def _write_ranks(path, ranks):
    path.write_text("\n".join(base64.b64encode(tok).decode() + f" {rank}"
                              for tok, rank in ranks.items()))


def test_get_tokenizer_resolves_tiktoken_like_jax(tmp_path):
    """A model dir holding a ranks asset (and no HF files), and the asset's
    own path, select the legacy tokenizer in both packages (language and
    task as JAX sets them); ids, decodes and the sot sequence agree."""
    _write_ranks(tmp_path / "multilingual.tiktoken", _ranks())
    port_tok.get_tokenizer.cache_clear()
    jax_tok.get_tokenizer.cache_clear()
    for path in (str(tmp_path), str(tmp_path / "multilingual.tiktoken")):
        ours, theirs = port_tok.get_tokenizer(path), jax_tok.get_tokenizer(path)
        assert isinstance(ours, port_lt.LegacyTokenizer)
        assert isinstance(theirs, jax_lt.LegacyTokenizer)
        assert ours.sot_sequence == theirs.sot_sequence == (
            ours.sot, ours.special_tokens["<|en|>"], ours.transcribe)
        for text in TEXTS:
            ids = ours.encode(text)
            assert ids == theirs.encode(text)
            assert ours.decode(ids) == theirs.decode(ids) == text
    lt = port_lt.get_legacy_tokenizer(str(tmp_path / "multilingual.tiktoken"), language="fr")
    assert lt.sot_sequence[1] == lt.special_tokens["<|fr|>"]
    assert port_lt.get_legacy_tokenizer(str(tmp_path / "multilingual.tiktoken"),
                                        multilingual=False).sot_sequence == (lt.sot,)
