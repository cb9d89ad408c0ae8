"""Warmup in the port (``utils/synthetic.py``, ``runtime/warmup.py``,
``Cosy2EU.warmup``) against the JAX package's, on the CPU.

``synthetic_prompt`` makes JAX's numpy calls in JAX's order: its arrays are
equal to JAX's for one seed (no tolerance).  The programs run on a small
config: the tiny one with a text vocabulary of 50000, since the synthetic
text ids run up to 50000 (JAX's ``jnp.take`` clamps an id past its table;
the port's indexing raises), 1024 LM positions, since ``tts_batch``'s 6 s
prompts fill the tiny config's 256, and at most 4 speech tokens a text
token, to bound the CPU's time (random weights rarely stop early)."""

import dataclasses

import numpy as np
import pytest

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch.config import TTSConfig as PortTTSConfig
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.runtime import warmup
from cosyvoice2_eu_torch.utils.synthetic import synthetic_prompt
from cosyvoice2_eu_tpu.config import TTSConfig
from cosyvoice2_eu_tpu.utils.synthetic import synthetic_prompt as jax_synthetic_prompt

FIELDS = ("text_tokens", "prompt_text_tokens", "llm_prompt_speech_tokens",
          "flow_prompt_speech_tokens", "prompt_feat", "embedding")


def small_config():
    cfg = port_tiny()
    bb = dataclasses.replace(cfg.llm.backbone, vocab_size=50000)
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, backbone=bb, max_seq_len=1024, max_token_text_ratio=4.0))


@pytest.fixture(scope="module")
def api():
    return port.load(config=small_config(), seed=0, device="cpu", compute_dtype="float32")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_prompt_equals_jax(seed):
    """The published config's prompt of 75 tokens (3 s), field by field."""
    got = synthetic_prompt(PortTTSConfig(), np.random.default_rng(seed), 75)
    want = jax_synthetic_prompt(TTSConfig(), np.random.default_rng(seed), 75)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.prompt_feat.shape == (150, 80)


def test_warmup_programs_drives_every_mode(api, monkeypatch):
    """Per prompt bucket one ``tts`` without streaming and two with it (the
    second from the prompt's primed flow state): 3 modes a bucket, plus
    ``tts_batch`` when ``batch`` is set; a CPU model builds no kernel."""
    from cosyvoice2_eu_torch.ops import cuda_build

    calls = []
    monkeypatch.setattr(cuda_build, "build", lambda sources: calls.append(sources))
    tm = api._model
    seen = []
    tts = tm.tts
    monkeypatch.setattr(tm, "tts", lambda p, stream=False, **kw: (
        seen.append((len(p.llm_prompt_speech_tokens), stream)) or tts(p, stream=stream, **kw)))
    stats = warmup.warmup_programs(tm, prompt_seconds=(1,), batch=2)
    assert stats["modes"] == 3 + 1 and stats["seconds"] > 0
    assert stats["store_stats"] == {"loaded": [], "built": []} and calls == []
    assert seen == [(25, False), (25, True), (25, True)]
    assert len(tm.last_batch_tokens) == 2 and min(tm.last_batch_tokens) > 0
    assert len(tm._primed_cache) == 1


def test_warmup_engine_runs(api):
    """Two rounds of ``n_slots`` concurrent requests through a
    ``TTSEngine``, which is closed after them."""
    tm = api._model
    tm.timer.reset()
    stats = warmup.warmup_engine(tm, n_slots=2)
    assert stats["engine_seconds"] > 0
    summary = tm.timer.summary()
    assert summary["eng_prefill"]["count"] == 4 and summary["eng_decode"]["count"] > 0


def test_cosy2eu_warmup_returns_seconds_and_drops_the_primed_prompt(api):
    """``Cosy2EU.warmup`` synthesizes once without and twice with streaming
    over a synthetic prompt, returns its wall seconds and leaves the primed
    cache empty, as JAX's."""
    tm = api._model
    tm.timer.reset()
    seconds = api.warmup(stream=True, prompt_seconds=1.0)
    assert seconds > 0 and tm._primed_cache == {}
    assert tm.last_n_tokens > 0 and "prompt_prime" in tm.timer.summary()
    assert api.warmup(stream=False, prompt_seconds=1.0) > 0
