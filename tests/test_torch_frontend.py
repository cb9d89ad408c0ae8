"""The port's prompt frontend against the JAX package's on the CPU (tiny
widths): reading and resampling wavs, the speech-tokenizer and speaker
functions, ``Frontend.extract_prompt`` and the three prompt builders, and
``Cosy2EU.tts``/``stream`` on wav paths and waveforms under the JAX
model's draws, with the prompt cache and ``add_zero_shot_spk``."""

import dataclasses
import wave

import jax
import numpy as np
import pytest
import torch
from test_torch_aux_models import _perturbed_bn
from test_torch_stream import _max_gen, hift_key_chain
from torch_parity import jax_tts_params, lm_draws_from_key, to_numpy

import cosyvoice2_eu_torch as port
import cosyvoice2_eu_tpu as cosy_jax
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.frontend import frontend as port_fe
from cosyvoice2_eu_torch.models import campplus as port_cam
from cosyvoice2_eu_torch.models import speech_tokenizer as port_st
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.frontend import frontend as jax_fe
from cosyvoice2_eu_tpu.models import campplus as jax_cam
from cosyvoice2_eu_tpu.models import speech_tokenizer as jax_st
from cosyvoice2_eu_tpu.runtime import model as jax_model

CFG = tiny_test_config()
PCFG = port_tiny()
# 81 codes (fsq_dim 4) for the tiny LM's speech vocabulary, 192-d x-vectors for the flow
JTOK = dataclasses.replace(jax_st.tiny_tokenizer_config(), fsq_dim=4)
PTOK = dataclasses.replace(port_st.tiny_tokenizer_config(), fsq_dim=4)
JCAM = dataclasses.replace(jax_cam.tiny_campplus_config(), embedding_size=192)
PCAM = dataclasses.replace(port_cam.tiny_campplus_config(), embedding_size=192)
# prompt mel: fp32 FFT error is relative to a frame's energy, so the mel is
# compared linearly, within 1e-6 of its largest value (in the log domain a
# bin 60 dB down, e.g. above 8 kHz of a 16 kHz prompt, moves by ~1e-4)
FEAT_REL = 1e-6
EMB_REL = 1e-5  # x-vector, relative to its largest value
AUDIO_TOL = 1e-3  # fp32 through the LM, 10 Euler steps and HiFT, as the other parity tests


def assert_mel_close(got, want):
    lin_got, lin_want = np.exp(got.astype(np.float64)), np.exp(want.astype(np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(lin_got, lin_want, atol=FEAT_REL * lin_want.max())


def write_wav(path, seconds, sr=16000, channels=1, width=2, seed=0):
    """A harmonic glide plus noise as PCM; returns the samples written (float)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 60.0 * t / max(seconds, 1e-3)
    sig = sum(0.25 / k * np.sin(2 * np.pi * k * np.cumsum(f0) / sr) for k in (1, 2, 3))
    sig = np.stack([sig * (0.8 + 0.2 * c) for c in range(channels)], axis=1)
    sig = np.clip(sig + 0.02 * rng.standard_normal(sig.shape), -1, 1)
    scale, dtype = (32767, np.int16) if width == 2 else (2**31 - 1, np.int32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes((sig * scale).astype(dtype).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def aux_params():
    st = to_numpy(jax_st.init_speech_tokenizer(jax.random.key(0), JTOK))
    cam = _perturbed_bn(to_numpy(jax_cam.init_campplus(jax.random.key(1), JCAM)),
                        np.random.default_rng(5))
    return st, cam


@pytest.fixture(scope="module")
def fns(aux_params):
    """(port tokenizer fn, port speaker fn, JAX tokenizer fn, JAX speaker fn)."""
    st, cam = aux_params
    return (port_fe.make_speech_tokenizer_fn(st, PTOK, device="cpu"),
            port_fe.make_spk_embedding_fn(cam, PCAM, device="cpu"),
            jax_fe.make_speech_tokenizer_fn(st, JTOK), jax_fe.make_spk_embedding_fn(cam, JCAM))


@pytest.fixture(scope="module")
def frontends(fns):
    return (port_fe.Frontend(PCFG, speech_tokenizer_fn=fns[0], spk_embedding_fn=fns[1],
                             device="cpu"),
            jax_fe.Frontend(CFG, speech_tokenizer_fn=fns[2], spk_embedding_fn=fns[3]))


# ---------------------------------------------------------------------------
# wavs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr,channels,width", [(16000, 1, 2), (16000, 1, 4), (48000, 2, 2),
                                               (22050, 1, 2), (24000, 2, 4)])
def test_load_wav_matches_jax(tmp_path, sr, channels, width):
    """16- and 32-bit PCM, channels averaged, resampled to 16 kHz: the same
    numpy and scipy arithmetic, bit for bit."""
    path = write_wav(tmp_path / "p.wav", 0.3, sr, channels, width)
    got = port_fe.load_wav(path, 16000)
    want = jax_fe.load_wav(path, 16000)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert abs(len(got) - 0.3 * 16000) <= 1
    np.testing.assert_array_equal(got, want)


def test_load_wav_rejects_8_bit(tmp_path):
    with wave.open(str(tmp_path / "p.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(16000)
        w.writeframes(bytes(160))
    with pytest.raises(ValueError, match="sample width 1"):
        port_fe.load_wav(str(tmp_path / "p.wav"), 16000)


@pytest.mark.parametrize("sr,target", [(16000, 24000), (48000, 16000), (22050, 16000),
                                       (16000, 16000)])
def test_resample_matches_jax(sr, target):
    x = np.random.default_rng(sr).standard_normal(sr // 5).astype(np.float32)
    np.testing.assert_array_equal(port_fe.resample(x, sr, target), jax_fe.resample(x, sr, target))


# ---------------------------------------------------------------------------
# the speech tokenizer and speaker functions, extract_prompt, the builders
# ---------------------------------------------------------------------------


def _wave16k(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * 170.0 * t) + 0.05 * rng.standard_normal(len(t))) \
        .astype(np.float32)


@pytest.mark.parametrize("seconds", [0.4, 0.73, 1.0])
def test_tokenizer_and_speaker_fns_match_jax(fns, seconds):
    """Whisper log-mel cut to a multiple of the downsample, then ``encode``:
    equal codes; kaldi fbank then CAM++: the x-vector within 1e-5."""
    wav = _wave16k(seconds, 1)
    codes = fns[0](wav)
    np.testing.assert_array_equal(codes, fns[2](wav))
    assert codes.dtype == np.int32 and len(codes) == (len(wav) // 160) // 4
    emb, want = fns[1](wav), fns[3](wav)
    assert emb.shape == want.shape == (192,)
    np.testing.assert_allclose(emb, want, atol=EMB_REL * np.abs(want).max())


def test_tokenizer_fn_rejects_past_30_seconds(fns):
    """The JAX package asserts (dropped under ``python -O``); the port raises."""
    with pytest.raises(ValueError, match="30 s"):
        fns[0](np.zeros(30 * 16000 + 160, np.float32))


@pytest.mark.parametrize("seconds", [0.4, 0.73])
def test_extract_prompt_matches_jax(frontends, seconds):
    """The 24 kHz mel within 1e-6 of its peak, codes equal, the x-vector within 1e-5,
    and the mel trimmed to twice the tokens."""
    fe, jfe = frontends
    wav = _wave16k(seconds, 2)
    got, want = fe.extract_prompt(wav, "bonjour"), jfe.extract_prompt(wav, "bonjour")
    assert got["prompt_text"] == want["prompt_text"] == "bonjour"
    np.testing.assert_array_equal(got["speech_tokens"], want["speech_tokens"])
    assert got["prompt_feat"].shape == (2 * len(got["speech_tokens"]), 80)
    assert_mel_close(got["prompt_feat"], want["prompt_feat"])
    np.testing.assert_allclose(got["embedding"], want["embedding"],
                               atol=EMB_REL * np.abs(want["embedding"]).max())


def test_extract_prompt_trims_to_the_shorter_side(frontends):
    """Precomputed tokens shorter than half the mel cut the mel; more tokens
    than half the mel are cut instead (the 2:1 alignment)."""
    fe, jfe = frontends
    wav = _wave16k(0.4, 3)  # 20 mel frames
    for n in (6, 14):
        toks = np.arange(n, dtype=np.int32)
        got = fe.extract_prompt(wav, precomputed_speech_tokens=toks,
                                precomputed_embedding=np.ones(192))
        want = jfe.extract_prompt(wav, precomputed_speech_tokens=toks,
                                  precomputed_embedding=np.ones(192))
        k = min(n, 10)
        assert got["prompt_feat"].shape == want["prompt_feat"].shape == (2 * k, 80)
        np.testing.assert_array_equal(got["speech_tokens"], toks[:k])
        assert got["embedding"].dtype == np.float32


def test_extract_prompt_rejects_past_30_seconds_and_missing_models(frontends):
    fe, _ = frontends
    with pytest.raises(ValueError, match="30 s"):
        fe.extract_prompt(np.zeros(30 * 16000 + 1, np.float32))
    bare = port_fe.Frontend(PCFG, device="cpu")
    with pytest.raises(ValueError, match="no speech tokenizer available"):
        bare.extract_prompt(_wave16k(0.2))
    with pytest.raises(ValueError, match="no speaker embedding model"):
        bare.extract_prompt(_wave16k(0.2), precomputed_speech_tokens=np.arange(5))


@pytest.mark.parametrize("mode", ["zero_shot", "cross_lingual", "instruct2"])
def test_prompt_builders_equal_jax(frontends, mode):
    fe, jfe = frontends
    art = fe.extract_prompt(_wave16k(0.4, 4), "Salut.")
    args = ("Bonjour tout le monde.",) + (("Parle lentement.",) if mode == "instruct2" else ())
    got = getattr(fe, f"frontend_{mode}")(*args, art)
    want = getattr(jfe, f"frontend_{mode}")(*args, art)
    for field in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, field.name), getattr(want, field.name))


def test_frontend_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    """The frontend and both factories run on the card by default: without
    one they raise, and they never go on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: port_fe.Frontend(PCFG),
                  lambda: port_fe.make_speech_tokenizer_fn({}, PTOK),
                  lambda: port_fe.make_spk_embedding_fn({}, PCAM)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# ---------------------------------------------------------------------------
# Cosy2EU on wav prompts against the JAX package
# ---------------------------------------------------------------------------


def _mel_at_flow_width(cfg):
    """The tiny flow reads 16-bin mels: the prompt mel follows it."""
    return dataclasses.replace(cfg, mel=dataclasses.replace(cfg.mel,
                                                            num_mels=cfg.flow.output_size))


@pytest.fixture(scope="module")
def apis(fns):
    params = jax_tts_params(CFG, seed=0)
    cfg, pcfg = _mel_at_flow_width(CFG), _mel_at_flow_width(PCFG)
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None)
    pm = port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None, device="cpu")
    japi = cosy_jax.Cosy2EU(jm, jax_fe.Frontend(cfg, speech_tokenizer_fn=fns[2],
                                                spk_embedding_fn=fns[3]), cfg)
    papi = port.Cosy2EU(pm, port_fe.Frontend(pcfg, speech_tokenizer_fn=fns[0],
                                             spk_embedding_fn=fns[1], device="cpu"), pcfg)
    return papi, japi


def _under_jax_draws(papi, japi, key):
    """Seed the JAX model with ``key`` and hand the port's ``tts`` the draws
    JAX makes from it (LM key first, then one key per HiFT call)."""
    jm, pm = japi._model, papi._model
    jm._rng = key
    r1, k_lm = jax.random.split(key)

    def tts(inputs, **kw):
        return port_model.TTSModel.tts(pm, inputs, lm_draws=lm_draws_from_key(
            k_lm, 1, _max_gen(pm, inputs), CFG.llm.top_k, CFG.llm.full_vocab),
            hift_draws=hift_key_chain(r1), **kw)

    pm.tts = tts


@pytest.mark.parametrize("prompt,stream,mode", [
    ("path", False, "zero_shot"), ("array", True, "cross_lingual"),
    ("path", True, "instruct2"), ("array", False, "instruct2")])
def test_cosy2eu_wav_prompt_matches_jax(apis, tmp_path, prompt, stream, mode):
    """The user's call with a wav prompt, through both packages with the same
    weights and draws: text normalised (a number spelled out), the same
    chunks and audio within 1e-3."""
    papi, japi = apis
    path = write_wav(tmp_path / "prompt.wav", 0.4, seed=6)
    src = path if prompt == "path" else jax_fe.load_wav(path, 16000)
    kw = dict(prompt_text="Salut, ça va ?", text_frontend=True, mode=mode,
              instruct_text="Parle lentement.")
    text = "Il y a 3 chats."
    assert papi._frontend.normalize_text(text) == ["Il y a trois chats."]
    _under_jax_draws(papi, japi, jax.random.key(21))
    if stream:
        got = [c[0] for c in papi.stream(text, src, **kw)]
        want = [c[0] for c in japi.stream(text, src, **kw)]
    else:
        got, want = [papi.tts(text, src, **kw)[0][0]], [japi.tts(text, src, **kw)[0][0]]
    assert [len(c) for c in got] == [len(c) for c in want]
    assert sum(len(c) for c in got) == papi._model.last_n_tokens * 960
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=AUDIO_TOL)


def test_prompt_cache_hits_and_never_evicts(apis, tmp_path):
    """A wav path is extracted once per (path, prompt text): a second call
    hits the cache, and a file rewritten in place is still served from it
    (the reference's behaviour, reproduced in both packages)."""
    papi, japi = apis
    path = write_wav(tmp_path / "cached.wav", 0.4, seed=7)
    first = papi._prepare(path, "a")
    count = papi._frontend.timer.counts["prompt_mel"]
    assert papi._prepare(path, "a") is first
    assert papi._frontend.timer.counts["prompt_mel"] == count
    write_wav(path, 0.5, seed=8)  # rewritten in place
    assert papi._prepare(path, "a") is first
    jfirst = japi._prepare(path, "a")  # JAX's first read sees the new file ...
    write_wav(path, 0.4, seed=9)
    assert japi._prepare(path, "a") is jfirst  # ... and keeps it, as the port does
    assert papi._prepare(path, "b") is not first  # another prompt text: extracted anew
    assert (path, "b") in papi._prompt_cache and len(papi._prompt_cache) >= 2


def test_add_zero_shot_spk_on_a_wav_matches_jax(apis, tmp_path):
    papi, japi = apis
    path = write_wav(tmp_path / "spk.wav", 0.4, seed=10)
    assert papi.add_zero_shot_spk("Salut.", path, "alice") is True
    assert japi.add_zero_shot_spk("Salut.", path, "alice") is True
    got, want = papi._frontend.get_spk("alice"), japi._frontend.get_spk("alice")
    assert got is papi._prompt_cache[(path, "Salut.")] and got["prompt_text"] == "Salut."
    np.testing.assert_array_equal(got["speech_tokens"], want["speech_tokens"])
    assert_mel_close(got["prompt_feat"], want["prompt_feat"])
    np.testing.assert_allclose(got["embedding"], want["embedding"],
                               atol=EMB_REL * np.abs(want["embedding"]).max())
