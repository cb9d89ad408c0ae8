"""The port's ``StreamSession`` and the paths that run it against the JAX
package (tiny config, fp32, CPU): synthesis past the largest flow bucket
under ``cached_stream=True`` (``_finalize_full``, ``tts_batch``'s per-row
fallback) and ``vc``.  HiFT's draws are rebuilt from JAX's ``_next_rng``
chain (``test_torch_stream.hift_key_chain``), so every chunk is compared:
equal count and lengths, audio atol 1e-3."""

import jax
import numpy as np
import pytest
import torch
from test_torch_stream import hift_key_chain
from torch_parity import jax_tts_params, to_numpy

from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_torch.serving.engine import StreamSession
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.runtime import model as jax_model
from cosyvoice2_eu_tpu.serving.engine import StreamSession as JaxStreamSession

CFG = tiny_test_config()
PCFG = port_tiny()
SCALE = CFG.hift.upsample_scale * CFG.flow.token_mel_ratio  # samples per token
# a cached window small enough for the tiny config to roll over and escalate
# its steady chunk to 50 and 100 tokens within a few hundred tokens, and a
# flow bucket of 128 tokens to pass
SESSION = dict(stream_max_tokens=256, stream_rollover_window=50)
BUCKETS = (64, 128)


@pytest.fixture(scope="module")
def params():
    return jax_tts_params(CFG, seed=0)


@pytest.fixture(scope="module")
def jm(params):
    """One JAX model for the file: its compiled programs serve every test."""
    return jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None, **SESSION)


@pytest.fixture
def buckets(monkeypatch):
    """The largest flow bucket cut to 128 tokens in both packages."""
    monkeypatch.setattr(port_model, "FLOW_TOKEN_BUCKETS", BUCKETS)
    monkeypatch.setattr(jax_model, "FLOW_TOKEN_BUCKETS", BUCKETS)


def _port(params, **kw):
    return port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None,
                               device="cpu", **{**SESSION, **kw})


def _inputs(cls, seed=0, n_sp=6):
    rng = np.random.default_rng(seed)
    return cls(
        text_tokens=rng.integers(2, 200, 12).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, CFG.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, CFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, CFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
    )


def _tokens(n, seed=11):
    return np.random.default_rng(seed).integers(0, CFG.flow.vocab_size, n).astype(np.int32)


def _same_chunks(got, want):
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3)


@pytest.mark.parametrize("entry", ["stream", "finalize_full"])
def test_session_past_the_bucket_matches_jax(params, jm, buckets, entry):
    """400 tokens through ``StreamSession``, fed one token at a time as
    ``_wav_from_token_gen`` feeds it: the first emission by recompute,
    steady chunks of 25, then 50 and 100 tokens, a rollover at the
    256-token cap and the windowed finalize.  ``stream`` compares chunk by
    chunk; ``finalize_full`` is the non-streaming entry past the largest
    flow bucket, which joins the same chunks."""
    pm = _port(params)
    tokens = _tokens(400)
    jm._rng = jax.random.key(3)
    draws = hift_key_chain(jm._rng)
    if entry == "stream":
        want = list(jm._wav_from_token_gen(iter(tokens), _inputs(jax_model.PromptInputs), True))
        got = list(pm._wav_from_token_gen(iter(tokens), _inputs(port_model.PromptInputs), True,
                                          hift_draws=draws))
        counts = pm.timer.counts
        assert counts["first_chunk_recompute"] == 1 and counts["stream_rollover"] >= 1
        assert counts["stream_chunk[25]"] >= 1 and counts["stream_chunk[50]"] >= 1
        assert counts["stream_chunk[100]"] >= 1
    else:
        want = [jm._finalize_full(tokens, _inputs(jax_model.PromptInputs), {"hift_cache": None})]
        got = [pm._finalize_full(tokens, _inputs(port_model.PromptInputs), {"hift_cache": None},
                                 hift_draws=draws)]
        assert pm.timer.counts["stream_rollover"] >= 1
    _same_chunks(got, want)
    assert sum(len(c) for c in got) == 400 * SCALE


def test_session_cap_hit_drains_like_jax(params, jm, buckets, monkeypatch):
    """A cap smaller than prompt + the first hop: the session never caches,
    and the finalize drains 150 tokens in hop-sized recompute chunks inside
    the 128-token bucket, then the final chunk (as ``tests/test_engine.py``'s
    cap-hit case)."""
    monkeypatch.setattr(jm, "stream_max_tokens", 48)
    pm = _port(params, stream_max_tokens=48)
    tokens = _tokens(150)
    jm._rng = jax.random.key(4)
    draws = hift_key_chain(jm._rng)
    want = JaxStreamSession(jm, _inputs(jax_model.PromptInputs)).feed(tokens, lm_finished=True)
    sess = StreamSession(pm, _inputs(port_model.PromptInputs), hift_draws=draws)
    got = sess.feed(tokens, lm_finished=True)
    assert len(got) >= 3 and sess.first_pending and sess.fstate is None  # drained, no cache
    assert pm.timer.counts["flow"] == len(got)
    _same_chunks(got, want)
    assert sum(len(c) for c in got) == 150 * SCALE
    assert sess.feed(tokens, lm_finished=True) == []  # done


def test_session_speed_renders_in_one_shot_like_jax(params, jm):
    """``speed != 1.0`` renders the flow and HiFT once, at the end, with the
    mel stretched; nothing is emitted before ``lm_finished``."""
    pm = _port(params)
    tokens = _tokens(60)
    jm._rng = jax.random.key(5)
    draws = hift_key_chain(jm._rng)
    j_sess = JaxStreamSession(jm, _inputs(jax_model.PromptInputs), speed=1.5)
    sess = StreamSession(pm, _inputs(port_model.PromptInputs), speed=1.5, hift_draws=draws)
    assert sess.feed(tokens, False) == [] and j_sess.feed(tokens, False) == []
    got, want = sess.feed(tokens, True), j_sess.feed(tokens, True)
    assert len(got) == 1 and len(got[0]) == int(60 * 2 / 1.5) * CFG.hift.upsample_scale
    _same_chunks(got, want)


def test_session_speed_past_the_bucket_raises_like_jax(params, jm, buckets):
    """Past the largest flow bucket a one-shot render cannot fit: both
    packages raise ``bucket_for``'s ``ValueError`` (the recompute loop's
    docstring promise, speed on the final chunk only, holds only under
    ``cached_stream=False``)."""
    tokens = _tokens(150)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        jm._finalize_full(tokens, _inputs(jax_model.PromptInputs), {"hift_cache": None}, 1.5)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        _port(params)._finalize_full(tokens, _inputs(port_model.PromptInputs),
                                     {"hift_cache": None}, 1.5)


def test_tts_batch_long_row_matches_jax(params, jm, buckets, monkeypatch):
    """``tts_batch`` with one row past the largest flow bucket falls back to
    per-row synthesis (as ``tests/test_runtime.py``'s case, the decode
    replaced by fixed rows of 140 and 20 tokens): the long row through
    ``StreamSession``, the short one in one shot, each equal to JAX's."""
    rows = np.tile(np.arange(140, dtype=np.int32) % CFG.flow.vocab_size, (2, 1))
    lengths = np.asarray([140, 20], np.int32)
    monkeypatch.setattr(jax_model.TTSModel, "_lm_decode_fn",
                        lambda self, p, g: lambda *a: (rows, lengths))
    monkeypatch.setattr(port_model.llm_mod, "lm_decode",
                        lambda *a, **k: (torch.as_tensor(rows), torch.as_tensor(lengths), 140))
    jm._rng = jax.random.key(6)
    r1, _ = jax.random.split(jm._rng)  # the LM's key, drawn even with the decode replaced
    want = jm.tts_batch([_inputs(jax_model.PromptInputs, s) for s in (0, 1)])
    pm = _port(params)
    got = pm.tts_batch([_inputs(port_model.PromptInputs, s) for s in (0, 1)],
                       hift_draws=hift_key_chain(r1))
    assert [len(w) for w in got] == [140 * SCALE, 20 * SCALE]
    assert pm.timer.counts["first_chunk_recompute"] == 1  # the long row streamed
    _same_chunks(got, want)


@pytest.mark.parametrize("stream", [False, True])
def test_vc_matches_jax(params, jm, stream):
    """``vc`` skips the LM: one flow and HiFT call, or recompute chunks of
    a hop and the lookahead over the growing prefix, then the final one."""
    pm = _port(params)
    source = _tokens(80, seed=6)
    jm._rng = jax.random.key(7)
    draws = hift_key_chain(jm._rng)
    want = list(jm.vc(source, _inputs(jax_model.PromptInputs), stream=stream))
    got = list(pm.vc(source, _inputs(port_model.PromptInputs), stream=stream, hift_draws=draws))
    assert len(got) == (4 if stream else 1) and pm.timer.counts["flow"] == len(got)
    _same_chunks(got, want)
    assert sum(len(c) for c in got) == 80 * SCALE


@pytest.mark.parametrize("stream", [False, True])
def test_vc_past_the_bucket_raises_like_jax(params, jm, buckets, stream):
    """``vc`` does not window: a source whose prompt plus tokens pass the
    largest flow bucket raises ``bucket_for``'s ``ValueError`` in both
    packages (streaming too, at its final chunk)."""
    source = _tokens(130, seed=8)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        list(jm.vc(source, _inputs(jax_model.PromptInputs), stream=stream))
    with pytest.raises(ValueError, match="exceeds max bucket"):
        list(_port(params).vc(source, _inputs(port_model.PromptInputs), stream=stream))
