"""Streaming synthesis of the port against the JAX package (tiny config,
fp32, CPU): the LM's resumable decode, the vocoder cache, ``tts(stream=True)``
on the cached and the recompute path, and the streaming runtime's own
properties (rollover, primed prompts, streams shorter than one chunk,
windowing past the largest flow bucket, one seed's tokens with and without
streaming)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import hift_draws_from_key, jax_tts_params, lm_draws_from_key, t, to_numpy

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.runtime import model as jax_model

CFG = tiny_test_config()
PCFG = port_tiny()
SCALE = CFG.hift.upsample_scale * CFG.flow.token_mel_ratio  # samples per token


@pytest.fixture(scope="module")
def params():
    return jax_tts_params(CFG, seed=0)


def _port(params, **kw):
    kw.setdefault("seed", 7)
    return port_model.TTSModel(PCFG, to_numpy(params), compute_dtype=None, device="cpu", **kw)


def _inputs(cls, seed=0, n_text=12, n_sp=6):
    rng = np.random.default_rng(seed)
    return cls(
        text_tokens=rng.integers(2, 200, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, CFG.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, CFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, CFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
    )


def hift_key_chain(rng):
    """``hift_draws`` that hands each HiFT call, in turn, the draws of the key
    JAX's ``TTSModel._next_rng`` hands out next, starting from ``rng``."""
    keys = {"rng": rng}

    def draws(batch, length, harmonics):
        keys["rng"], sub = jax.random.split(keys["rng"])
        return hift_draws_from_key(sub)(batch, length, harmonics)

    return draws


def _max_gen(pm, inputs):
    _, _, _, p_bucket, _, max_len = pm._pack_lm_prompt(inputs)
    return min(((max_len + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)


# ---------------------------------------------------------------------------
# the LM's resumable decode
# ---------------------------------------------------------------------------


def test_lm_decode_chunk_matches_one_shot_and_jax(params):
    """A decode in uneven chunks equals the one-shot ``lm_decode`` (the draws
    are indexed by the absolute step) and JAX's ``lm_decode_chunk`` under its
    rebuilt draws, chunk by chunk: tokens, lengths and steps exactly."""
    jp = params["llm"]
    pp = _port(params).params["llm"]
    rng = np.random.default_rng(1)
    p_bucket, n_text, n_sp, max_gen = 64, 12, 8, 64
    ids = np.zeros((1, p_bucket), np.int32)
    src = np.zeros((1, p_bucket), np.int32)
    ids[0, 1:1 + n_text] = rng.integers(2, CFG.llm.backbone.vocab_size, n_text)
    src[0, 1:1 + n_text] = jax_llm.SRC_TEXT
    ids[0, 1 + n_text] = CFG.llm.task_id
    ids[0, 2 + n_text:2 + n_text + n_sp] = rng.integers(0, CFG.llm.speech_token_size, n_sp)
    src[0, 2 + n_text:2 + n_text + n_sp] = jax_llm.SRC_SPEECH
    prompt_len, min_len, max_len = (np.array([v], np.int32) for v in (2 + n_text + n_sp, 5, 50))
    key = jax.random.key(4)
    draws = lm_draws_from_key(key, 1, max_gen, CFG.llm.top_k, CFG.llm.full_vocab)
    pargs = [t(a).long() for a in (prompt_len, min_len, max_len)]

    want = port_llm.lm_decode(pp, PCFG.llm, t(ids).long(), t(src).long(), *pargs, max_gen,
                              draws=draws)
    st_j = jax_llm.lm_prefill(jp, CFG.llm, jnp.asarray(ids), jnp.asarray(src),
                              jnp.asarray(prompt_len), key, max_gen)
    chunk_j = jax.jit(jax_llm.lm_decode_chunk, static_argnums=(1, 6))
    st_p = port_llm.lm_prefill(pp, PCFG.llm, t(ids).long(), t(src).long(), pargs[0], max_gen)
    for target in (3, 10, 11, 29, 1000):
        st_j = chunk_j(jp, CFG.llm, st_j, *map(jnp.asarray, (prompt_len, min_len, max_len)),
                       p_bucket, jnp.asarray(target))
        st_p = port_llm.lm_decode_chunk(pp, PCFG.llm, st_p, *pargs, target, draws)
        assert isinstance(st_p.step, int) and st_p.step == int(st_j.step)
        np.testing.assert_array_equal(st_p.lengths.numpy(), np.asarray(st_j.lengths))
        np.testing.assert_array_equal(st_p.tokens.numpy(), np.asarray(st_j.tokens))
        np.testing.assert_array_equal(st_p.finished.numpy(), np.asarray(st_j.finished))
    assert bool(st_p.finished.all()) and st_p.step < max_gen  # ended early, on EOS
    assert torch.equal(st_p.tokens, want[0]) and torch.equal(st_p.lengths, want[1])
    assert st_p.step == want[2]


# ---------------------------------------------------------------------------
# the vocoder cache
# ---------------------------------------------------------------------------


def test_hift_chunk_sequence_matches_jax(params):
    """``_hift_chunk`` over a stream's chunks, each HiFT call with the draws of
    the key JAX's ``_next_rng`` hands it: a first chunk (no cache), a steady
    chunk (mel and source cache prepended, crossfade, withheld tail), a tiny
    chunk (fewer samples than the source cache) and a final one; audio
    (fp32 through HiFT, clipped to +-0.99) atol 1e-3, the cached tails too."""
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None)
    pm = _port(params)
    rng = np.random.default_rng(5)
    draws = hift_key_chain(jm._rng)
    s_j, s_p = {"hift_cache": None}, {"hift_cache": None}
    for frames, finalize in ((50, False), (50, False), (3, False), (38, True)):
        mel = rng.standard_normal((1, CFG.flow.output_size, frames)).astype(np.float32) - 3.0
        want = jm._hift_chunk(jnp.asarray(mel), s_j, finalize)
        got = pm._hift_chunk(t(mel), s_p, finalize, hift_draws=draws)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-3)
        if not finalize:
            cj, cp = s_j["hift_cache"], s_p["hift_cache"]
            np.testing.assert_allclose(cp["mel"].numpy(), np.asarray(cj["mel"]), atol=1e-6)
            np.testing.assert_allclose(cp["source"].numpy(), np.asarray(cj["source"]), atol=1e-3)
            np.testing.assert_allclose(cp["speech"], np.asarray(cj["speech"]), atol=1e-3)
    with pytest.raises(ValueError, match="speed"):
        pm._hift_chunk(t(mel), s_p, True, speed=1.5)


def test_hift_chunk_tiny_first_chunk_matches_jax(params):
    """A first chunk of 4 mel frames: 1920 samples, fewer than the 3840 of the
    source cache, so the cache keeps what there is."""
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None)
    pm = _port(params)
    mel = np.random.default_rng(6).standard_normal((1, CFG.flow.output_size, 4)).astype(
        np.float32) - 3.0
    s_j, s_p = {"hift_cache": None}, {"hift_cache": None}
    draws = hift_key_chain(jm._rng)
    want = jm._hift_chunk(jnp.asarray(mel), s_j, False)
    got = pm._hift_chunk(t(mel), s_p, False, hift_draws=draws)
    assert got.shape == want.shape == (0,)  # all withheld for the crossfade
    assert s_p["hift_cache"]["source"].shape == np.asarray(s_j["hift_cache"]["source"]).shape
    assert s_p["hift_cache"]["source"].shape[2] == 4 * CFG.hift.upsample_scale
    np.testing.assert_allclose(s_p["hift_cache"]["speech"], np.asarray(s_j["hift_cache"]["speech"]),
                               atol=1e-3)
    np.testing.assert_array_equal(s_p["hift_cache"]["mel"].numpy(), mel)


# ---------------------------------------------------------------------------
# tts(stream=True) against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached", [True, False])
def test_tts_stream_matches_jax(params, cached):
    """``tts(stream=True)`` on one path in both packages, the LM draws from
    the first key JAX's ``_next_rng`` hands out and each HiFT call's from the
    ones after: the same chunks (count and lengths) and audio, atol 1e-3.
    On the cached path JAX's steady chunks run its fused program (flow, HiFT,
    crossfade and cache rotation in one dispatch); the port's run a flow
    feed and ``_hift_chunk``, and give the same audio."""
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None, cached_stream=cached)
    pm = _port(params, cached_stream=cached)
    jm._rng = jax.random.key(21)
    r1, k_lm = jax.random.split(jm._rng)
    want = list(jm.tts(_inputs(jax_model.PromptInputs, 1, n_text=16), stream=True))
    inputs = _inputs(port_model.PromptInputs, 1, n_text=16)
    got = list(pm.tts(inputs, stream=True, lm_draws=lm_draws_from_key(
        k_lm, 1, _max_gen(pm, inputs), CFG.llm.top_k, CFG.llm.full_vocab),
        hift_draws=hift_key_chain(r1)))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert len(got) >= 4 and sum(len(c) for c in got) == pm.last_n_tokens * SCALE
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3)
    if cached:  # steady chunks on both sides
        hop = pm.token_hop_len
        assert jm.timer.counts.get(f"stream_chunk_fused[{hop}]", 0) >= 2
        assert pm.timer.counts.get(f"flow_chunk[{hop}]", 0) == jm.timer.counts[
            f"stream_chunk_fused[{hop}]"]


def test_stream_session_bytes_matches_jax(params):
    """The bytes of a session's caches at the token cap: JAX's count holds
    two more int32 scalars (its token and mel counters live on the device;
    the port keeps them as Python ints)."""
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None)
    pm = _port(params)
    assert pm.stream_session_bytes() + 2 * 4 == jm.stream_session_bytes()
    assert pm.stream_session_bytes() == pm._init_stream_state().nbytes()


# ---------------------------------------------------------------------------
# the streaming runtime's own properties (after tests/test_runtime.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached", [True, False])
def test_stream_and_non_stream_tokens_equal(params, cached):
    """Fresh models of one seed give the same tokens with and without
    streaming: the LM draws from a generator of its own, so the HiFT calls
    between decode chunks do not shift them; the audio lengths follow."""
    inputs = _inputs(port_model.PromptInputs, 2)
    full = np.concatenate(list(_port(params, seed=3).tts(inputs)))
    pm = _port(params, seed=3, cached_stream=cached)
    chunks = list(pm.tts(inputs, stream=True))
    assert len(chunks) >= 2 and len(np.concatenate(chunks)) == len(full)
    ref = _port(params, seed=3)
    list(ref.tts(inputs))
    assert pm.last_n_tokens == ref.last_n_tokens and pm.last_decode_steps == ref.last_decode_steps


def test_cold_and_warm_streams_identical(params):
    """A cold stream (first chunk by recompute while the prompt primes) and a
    warm one (the primed snapshot) give the same audio, and the snapshot
    survives the stream that used it (chunks update states in place)."""
    pm = _port(params)
    inputs = _inputs(port_model.PromptInputs, 5, n_sp=30)  # more than one hop of prompt
    pm.generator.manual_seed(55)
    cold = list(pm.tts(inputs, stream=True))
    assert len(pm._primed_cache) == 1 and pm.timer.counts["prompt_prime"] == 1
    pm.generator.manual_seed(55)
    warm = list(pm.tts(inputs, stream=True))
    assert pm.timer.counts["prompt_prime"] == 1  # served from the snapshot
    assert len(cold) == len(warm)
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c, w)


def test_primed_cache_is_bounded_and_keyed_on_the_whole_prompt(params):
    """At most 4 snapshots; two prompts that share their first speech tokens
    but not their mel get states of their own."""
    pm = _port(params)
    base = _inputs(port_model.PromptInputs, 5, n_sp=30)
    for i in range(5):
        p = port_model.PromptInputs(**{**base.__dict__,
                                       "prompt_feat": base.prompt_feat + i})
        pm._primed_flow_state(p)
    assert len(pm._primed_cache) == 4 and pm.timer.counts["prompt_prime"] == 5


def test_stream_rollover_long_utterance(params):
    """Past the cached window's cap a stream re-primes over the prompt and
    the last window of tokens and keeps streaming in bounded chunks: the
    whole utterance is vocoded, the chunks before the first rollover equal
    those of a stream without rollover."""
    kw = dict(stream_max_tokens=100, stream_rollover_window=25)
    m_roll, m_flat = _port(params, **kw), _port(params, stream_rollover=False, **kw)
    inputs = _inputs(port_model.PromptInputs, 3, n_text=90)
    m_roll.generator.manual_seed(11)
    chunks_roll = list(m_roll.tts(inputs, stream=True))
    m_flat.generator.manual_seed(11)
    chunks_flat = list(m_flat.tts(inputs, stream=True))
    m_roll.generator.manual_seed(11)
    full = np.concatenate(list(m_roll.tts(inputs, stream=False)))
    roll, flat = np.concatenate(chunks_roll), np.concatenate(chunks_flat)
    assert len(roll) == len(flat) == len(full)
    assert np.isfinite(roll).all() and len(roll) // SCALE > 100  # past the cap
    assert m_roll.timer.counts.get("stream_rollover", 0) >= 1
    hop = m_roll.token_hop_len
    assert all(len(c) <= 2 * hop * SCALE for c in chunks_roll[1:])
    assert len(chunks_roll) > len(chunks_flat)
    for a, b in zip(chunks_roll[:3], chunks_flat[:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cached", [True, False])
def test_stream_shorter_than_first_chunk(params, cached):
    """An utterance shorter than the first chunk (1 text token: at most 20
    speech tokens, against 6 + 19 + 25 + 3) streams as one final recompute:
    the same audio as ``tts(stream=False)`` on a fresh model of one seed, and
    the cached path allocates no flow state."""
    inputs = _inputs(port_model.PromptInputs, 4, n_text=1)
    full = list(_port(params, seed=5).tts(inputs))
    pm = _port(params, seed=5, cached_stream=cached)
    chunks = list(pm.tts(inputs, stream=True))
    assert len(chunks) == 1 and 0 < pm.last_n_tokens <= 20
    np.testing.assert_array_equal(chunks[0], full[0])
    assert not pm._primed_cache and not any(k.startswith("flow_chunk") for k in pm.timer.counts)


def test_wav_from_token_gen_windows_past_flow_bucket(params, monkeypatch):
    """The recompute streaming loop windows its context once prompt +
    generated would pass the largest flow bucket: every token vocoded once."""
    monkeypatch.setattr(port_model, "FLOW_TOKEN_BUCKETS", (64, 128))
    pm = _port(params, cached_stream=False)
    tokens = np.random.default_rng(9).integers(0, CFG.flow.vocab_size, 150).astype(np.int32)
    chunks = list(pm._wav_from_token_gen(iter(tokens), _inputs(port_model.PromptInputs),
                                         stream=True))
    total = np.concatenate(chunks)
    assert len(total) == 150 * SCALE and np.isfinite(total).all()


def test_recompute_tts_windows_past_flow_bucket(params, monkeypatch):
    """``tts(stream=True)`` on the recompute path windows the same way."""
    monkeypatch.setattr(port_model, "FLOW_TOKEN_BUCKETS", (64, 128))
    pm = _port(params, cached_stream=False)
    chunks = list(pm.tts(_inputs(port_model.PromptInputs, 9, n_text=90), stream=True))
    total = np.concatenate(chunks)
    assert len(total) == pm.last_n_tokens * SCALE and pm.last_n_tokens > 128 - 6
    assert np.isfinite(total).all()


@pytest.mark.parametrize("cached", [False, True])
def test_nonstream_finalize_windows_past_flow_bucket(params, monkeypatch, cached):
    """Non-streaming synthesis past the largest flow bucket joins the
    streaming schedule's chunks into one waveform: the windowed recompute
    loop, or under ``cached_stream=True`` the serving path's
    ``StreamSession``, which equals the JAX package's (HiFT draws rebuilt
    from its key chain, atol 1e-3)."""
    monkeypatch.setattr(port_model, "FLOW_TOKEN_BUCKETS", (64, 128))
    pm = _port(params, cached_stream=cached)
    tokens = np.random.default_rng(11).integers(0, CFG.flow.vocab_size, 150).astype(np.int32)
    inputs = _inputs(port_model.PromptInputs)
    draws = None
    if cached:
        monkeypatch.setattr(jax_model, "FLOW_TOKEN_BUCKETS", (64, 128))
        jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None)
        draws = hift_key_chain(jm._rng)
        want = list(jm._wav_from_token_gen(iter(tokens), _inputs(jax_model.PromptInputs),
                                           stream=False))
    chunks = list(pm._wav_from_token_gen(iter(tokens), inputs, stream=False, hift_draws=draws))
    assert len(chunks) == 1 and len(chunks[0]) == 150 * SCALE
    assert np.isfinite(chunks[0]).all()
    if cached:
        assert pm.timer.counts["first_chunk_recompute"] == 1  # through the session
        np.testing.assert_allclose(chunks[0], want[0], atol=1e-3)


def test_load_stream_on_cpu():
    """The user's entry point: ``load(device="cpu").stream`` yields (1, t)
    float32 chunks that add up to tokens x 960 samples."""
    model = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompt = {
        "prompt_feat": rng.standard_normal((12, PCFG.flow.output_size)).astype(np.float32),
        "speech_tokens": rng.integers(0, PCFG.llm.speech_token_size, 6).astype(np.int32),
        "embedding": rng.standard_normal(PCFG.frontend.spk_embed_dim).astype(np.float32),
    }
    chunks = list(model.stream("Bonjour tout le monde.", prompt))
    n = model._model.last_n_tokens
    assert len(chunks) >= 2 and all(c.ndim == 2 and c.shape[0] == 1 for c in chunks)
    assert all(c.dtype == np.float32 and np.isfinite(c).all() for c in chunks)
    assert sum(c.shape[1] for c in chunks) == n * 960
