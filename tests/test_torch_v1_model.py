"""The port's v1 runtime against the JAX package's on the CPU, at
``tests/test_v1_family.py``'s tiny bundle: ``CosyVoice1Model.tts`` and
``vc`` (streamed and not, ``speed=2.0``), ``load_v1`` (random weights,
``params=``, ``model_dir=`` written from numpy parameters, and its raise
without a GPU) and ``compat.CosyVoice``'s five modes with its speaker
store.  JAX's draws (its model's key chain) are handed to the port
(``torch_parity.V1KeyChain``); audio is held to 1e-3 absolute, as the
other end-to-end parity tests hold it."""

import dataclasses

import chip_smoke
import numpy as np
import pytest
import torch
from torch_parity import (
    V1KeyChain,
    reference_v1_state_dicts,
    tiny_v1_bundle,
    tiny_v1_params,
)

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch import compat as port_compat
from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.frontend.legacy_tokenizer import LegacyTokenizer
from cosyvoice2_eu_torch.models.flow_v1 import mel_len_for_tokens
from cosyvoice2_eu_torch.runtime.model_v1 import CosyVoice1Model
from cosyvoice2_eu_tpu import compat as jax_compat
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.runtime import model_v1 as jax_model_v1

AUDIO_TOL = 1e-3


@pytest.fixture(scope="module")
def bundle():
    jcfg, pcfg = tiny_v1_bundle(jax_config), tiny_v1_bundle(port_config)
    return jcfg, pcfg, tiny_v1_params(pcfg)


def _models(bundle, seed):
    jcfg, pcfg, params = bundle
    return (jax_model_v1.CosyVoice1Model(jcfg, params, seed=seed),
            CosyVoice1Model(pcfg, params, seed=seed, device="cpu"), V1KeyChain(seed))


def _draws(chain, cfg, lm=True):
    kw = dict(flow_noise=chain.flow_noise, hift_draws=chain.hift_draws)
    if lm:
        kw["lm_draws"] = chain.lm(cfg.llm)
    return kw


def _assert_chunks(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=AUDIO_TOL)


def _prompt(cfg, n_prompt, seed):
    rng = np.random.default_rng(seed)
    mel1 = mel_len_for_tokens(cfg.flow, n_prompt)
    return (rng.integers(0, cfg.llm.speech_token_size, n_prompt).astype(np.int32),
            rng.standard_normal((mel1, cfg.flow.output_size)).astype(np.float32),
            rng.standard_normal(cfg.llm.spk_embed_dim).astype(np.float32))


@pytest.mark.parametrize("stream", [False, True])
def test_tts_matches_jax(bundle, stream):
    """Text -> LM -> flow -> HiFT under JAX's draws: the same chunks within
    1e-3 (streamed: the growing hop with the mel crossfade and the source
    cache), then a second call on the same models (the key chain goes on)."""
    jm, pm, chain = _models(bundle, seed=1)
    cfg = bundle[1]
    rng = np.random.default_rng(13)
    text = rng.integers(1, cfg.llm.text_token_size, 6).astype(np.int32)
    ptext = rng.integers(1, cfg.llm.text_token_size, 2).astype(np.int32)
    psp, feat, emb = _prompt(cfg, 5, 14)
    for max_gen in (24, 30):
        want = list(jm.tts(text, ptext, psp, feat, emb, stream=stream, max_gen=max_gen))
        got = list(pm.tts(text, ptext, psp, feat, emb, stream=stream, max_gen=max_gen,
                          **_draws(chain, cfg)))
        _assert_chunks(got, want)
        n_tok = pm.last_n_tokens
        assert sum(len(g) for g in got) == (mel_len_for_tokens(cfg.flow, n_tok)
                                            * cfg.hift.upsample_scale)
        assert 12 <= n_tok <= max_gen  # min_len = 2 x 6 text tokens
    if stream:
        assert len(got) >= 2


def test_instruct_and_cross_lingual_plumbing_match_jax(bundle):
    """``llm_embedding=None`` (no speaker slot) and an empty LM prompt with
    the flow's prompt kept, as JAX plumbs them."""
    jm, pm, chain = _models(bundle, seed=2)
    cfg = bundle[1]
    rng = np.random.default_rng(15)
    text = rng.integers(1, cfg.llm.text_token_size, 5).astype(np.int32)
    psp, feat, emb = _prompt(cfg, 4, 16)
    empty = np.zeros(0, np.int32)
    for kw in (dict(llm_embedding=None), dict(llm_prompt_speech_tokens=empty)):
        want = list(jm.tts(text, empty, psp, feat, emb, max_gen=20, **kw))
        got = list(pm.tts(text, empty, psp, feat, emb, max_gen=20, **kw, **_draws(chain, cfg)))
        _assert_chunks(got, want)


def test_vc_matches_jax(bundle):
    """vc of 34 tokens: one chunk, then 4 streamed chunks (3 hops of 10
    tokens + 4 overlap and the final 4) summing to the same length, then
    speed 2.0 (the mel resampled before HiFT); a speed change while
    streaming raises."""
    jm, pm, chain = _models(bundle, seed=0)
    cfg = bundle[1]
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.flow.vocab_size - 1, 34).astype(np.int32)
    psp = rng.integers(0, cfg.flow.vocab_size - 1, 6).astype(np.int32)
    feat = rng.standard_normal((mel_len_for_tokens(cfg.flow, 6), cfg.flow.output_size)) \
        .astype(np.float32)
    emb = rng.standard_normal(cfg.flow.spk_embed_dim).astype(np.float32)
    expected = mel_len_for_tokens(cfg.flow, 34) * cfg.hift.upsample_scale
    for stream, speed, n_chunks, total in ((False, 1.0, 1, expected), (True, 1.0, 4, expected),
                                           (False, 2.0, 1, int(expected / 32 / 2.0) * 32)):  # hop 32
        want = list(jm.vc(tokens, psp, feat, emb, stream=stream, speed=speed))
        got = list(pm.vc(tokens, psp, feat, emb, stream=stream, speed=speed,
                         **_draws(chain, cfg, lm=False)))
        _assert_chunks(got, want)
        assert len(got) == n_chunks and sum(len(g) for g in got) == total
    with pytest.raises(ValueError, match="non-stream"):
        list(pm.vc(tokens, psp, feat, emb, stream=True, speed=2.0))


def test_text_outside_the_vocabulary_raises(bundle):
    """A text id or an LM prompt code past the LM's vocabularies raises in
    the port (JAX's gather fills NaN there)."""
    _, pm, _ = _models(bundle, seed=0)
    cfg = bundle[1]
    psp, feat, emb = _prompt(cfg, 4, 3)
    bad = np.array([cfg.llm.text_token_size], np.int32)
    with pytest.raises(ValueError, match="text vocabulary"):
        pm.tts(bad, np.zeros(0, np.int32), psp, feat, emb, max_gen=8)
    with pytest.raises(ValueError, match="speech vocabulary"):
        pm.tts(np.array([1], np.int32), np.zeros(0, np.int32),
               np.array([cfg.llm.speech_token_size], np.int32), feat, emb, max_gen=8)


def test_load_v1(bundle, tmp_path, monkeypatch):
    """``load_v1``: ``params=`` equals the model built from them; random
    weights from a seed repeat and synthesize; ``model_dir=`` with llm.pt,
    flow.pt, hift.pt written from the numpy parameters, a tiktoken ranks
    file and a speaker store gives the same parameters and tokenizer and
    the stored speaker; without a GPU the default device raises."""
    jcfg, pcfg, params = bundle
    model, frontend, cfg = port.load_v1(config=pcfg, params=params, device="cpu")
    assert cfg is pcfg and model.device.type == "cpu" and frontend.cfg is pcfg
    assert torch.equal(model.params["flow"]["encoder_proj"]["weight"],
                       torch.tensor(params["flow"]["encoder_proj"]["weight"]))
    a, _, _ = port.load_v1(config=pcfg, seed=3, device="cpu")
    b, _, _ = port.load_v1(config=pcfg, seed=3, device="cpu")
    assert torch.equal(a.params["llm"]["llm_decoder"]["weight"],
                       b.params["llm"]["llm_decoder"]["weight"])
    psp, feat, emb = _prompt(pcfg, 4, 5)
    wav = list(a.tts(np.arange(1, 6, dtype=np.int32), np.zeros(0, np.int32), psp, feat, emb,
                     max_gen=16))[0]
    assert np.isfinite(wav).all() and len(wav) == mel_len_for_tokens(
        pcfg.flow, a.last_n_tokens) * pcfg.hift.upsample_scale

    sd = reference_v1_state_dicts(params, pcfg)
    sd["hift"] = chip_smoke.reference_state_dicts({"hift": params["hift"]})["hift"]
    for name in ("llm", "flow", "hift"):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd[name].items()},
                   tmp_path / f"{name}.pt")
    import base64

    (tmp_path / "multilingual.tiktoken").write_text(
        "\n".join(base64.b64encode(bytes([i])).decode() + f" {i}" for i in range(256)))
    frontend.add_zero_shot_spk("alice", {"prompt_feat": feat, "speech_tokens": psp,
                                         "embedding": emb, "prompt_text": "Bonjour."})
    frontend.save_spk_info(str(tmp_path / "spk2info.npz"))
    loaded, lfront, _ = port.load_v1(model_dir=str(tmp_path), config=pcfg, device="cpu")
    for group in ("llm", "flow", "hift"):
        got = dict(_flat(loaded.params[group]))
        for path, want in _flat(model.params[group]):
            torch.testing.assert_close(got[path], want, rtol=0, atol=1e-6)
    assert isinstance(lfront.tokenizer, LegacyTokenizer)
    assert lfront.tokenizer.decode(lfront.tokenizer.encode("abc")) == "abc"
    np.testing.assert_array_equal(lfront.get_spk("alice")["speech_tokens"], psp)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.load_v1(config=pcfg, params=params)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_compat.CosyVoice(config=pcfg, params=params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _fake_frontend_fns(cfg):
    """Deterministic stand-ins for speech_tokenizer_v1.onnx / campplus.onnx
    (``tests/test_v1_family.py``'s, with codes inside the LM's speech
    vocabulary too: the JAX test's reach 30, past the tiny LM's 16)."""
    fr = cfg.flow.input_frame_rate
    vocab = min(cfg.flow.vocab_size, cfg.llm.speech_token_size)

    def tok_fn(wav_16k):
        n = max(2, int(round(len(wav_16k) / 16000 * fr)))
        return (np.arange(n) * 7 % (vocab - 1)).astype(np.int32)

    def spk_fn(wav_16k):
        return np.random.default_rng(len(wav_16k) % 97).standard_normal(
            cfg.flow.spk_embed_dim).astype(np.float32)

    return tok_fn, spk_fn


def test_compat_cosyvoice_matches_jax(bundle, tmp_path):
    """``compat.CosyVoice``: zero-shot, the speaker store with sft,
    cross-lingual, instruct (refused without "-Instruct", then without the
    LM's speaker slot) and vc, each within 1e-3 of JAX's under its draws;
    ``save_spkinfo`` with and without a model dir.  The LM's text
    vocabulary is widened to the byte tokenizer's 256 ids (the JAX test's
    40 would feed NaN embeddings to JAX's LM)."""
    jcfg, pcfg, _ = bundle
    jcfg, pcfg = (dataclasses.replace(c, llm=dataclasses.replace(c.llm, text_token_size=256))
                  for c in (jcfg, pcfg))
    params = tiny_v1_params(pcfg)
    jc = jax_compat.CosyVoice(config=jcfg, params=params)
    pc = port_compat.CosyVoice(config=pcfg, params=params, device="cpu")
    chain = V1KeyChain(0)
    tts, vc = pc.model.tts, pc.model.vc
    pc.model.tts = lambda *a, **k: tts(*a, **k, **_draws(chain, pcfg))
    pc.model.vc = lambda *a, **k: vc(*a, **k, **_draws(chain, pcfg, lm=False))
    for shim in (jc, pc):
        shim.frontend.speech_tokenizer_fn, shim.frontend.spk_embedding_fn = \
            _fake_frontend_fns(pcfg)
    rng = np.random.default_rng(21)
    prompt = torch.from_numpy(rng.standard_normal(32000).astype(np.float32) * 0.1)[None]
    source = rng.standard_normal(24000).astype(np.float32) * 0.1

    def both(call):
        want = [o["tts_speech"].numpy() for o in call(jc)]
        got = list(call(pc))
        assert all(o["tts_speech"].dtype == torch.float32 and o["tts_speech"].ndim == 2
                   and o["tts_speech"].shape[0] == 1 for o in got)
        _assert_chunks([o["tts_speech"].numpy() for o in got], want)

    both(lambda s: s.inference_zero_shot("Hello world.", "A prompt.", prompt,
                                         text_frontend=False))
    for shim in (jc, pc):
        assert shim.add_zero_shot_spk("A prompt.", prompt, "spk1")
        assert shim.list_available_spks() == ["spk1"]
    both(lambda s: s.inference_sft("Short text.", "spk1", text_frontend=False))
    both(lambda s: s.inference_cross_lingual("Texte.", prompt, stream=True, text_frontend=False))
    with pytest.raises(ValueError, match="instruct"):
        next(pc.inference_instruct("Text.", "spk1", "A deep voice.", text_frontend=False))
    jc.instruct = pc.instruct = True
    both(lambda s: s.inference_instruct("Instructed.", "spk1", "A deep voice.",
                                        text_frontend=False))
    both(lambda s: s.inference_vc(source, prompt))
    with pytest.raises(ValueError, match="model_dir"):
        pc.save_spkinfo()
    pc.model_dir = str(tmp_path)
    pc.save_spkinfo()
    assert (tmp_path / "spk2info.npz").exists()
    with pytest.raises(ValueError, match="empty"):
        pc.add_zero_shot_spk("", prompt, "")
