"""Serving a tensor-parallel model (``serving/engine.py``'s follower
protocol) on 2 gloo processes of the CPU (``tests/torch_dist_workers.py``),
against the same engine at ``tp=0`` in this process.

Tolerances: the same tokens (the engine's default draws, from a generator
seeded ``seed + 17`` on every process, under fp32 sums split over 2
processes); audio within 1e-5 (fp32, the same tokens through the same flow
and HiFT).  Every wait has a deadline: a rank's reads of its audio
(``torch_dist_workers.DRAIN_S``), the group's join (``run_group``), this
process's reads (``DEADLINE``)."""

import numpy as np
import pytest
import torch_dist_workers as W

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch.config import tiny_test_config
from cosyvoice2_eu_torch.runtime.model import PromptInputs
from cosyvoice2_eu_torch.serving import engine as port_engine

PCFG = tiny_test_config()
SCALE = PCFG.hift.upsample_scale * PCFG.flow.token_mel_ratio  # samples per token
ENGINE = dict(n_slots=4, chunk_steps=16, max_cache=256, max_gen=96)
DEADLINE = 120.0


def _prompt(seed, n_text=10, n_sp=6):
    rng = np.random.default_rng(seed)
    return PromptInputs(
        text_tokens=rng.integers(2, 200, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, PCFG.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, PCFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, PCFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(PCFG.frontend.spk_embed_dim).astype(np.float32),
    )


PROMPTS = [_prompt(1), _prompt(2, n_text=14)]
REFUSED = _prompt(3, n_text=300)  # its packed prompt's bucket (512) is past the 256-slot cache


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    rng = np.random.default_rng(4)
    spk = {"prompt_feat": rng.standard_normal((12, PCFG.flow.output_size)).astype(np.float32),
           "speech_tokens": rng.integers(0, PCFG.llm.speech_token_size, 6).astype(np.int32),
           "embedding": rng.standard_normal(192).astype(np.float32)}
    return W.run_group(W.tp_serving, 2, tmp_path_factory.mktemp("tp_serving"), config=PCFG,
                       prompts=PROMPTS, refused=REFUSED, engine_kw=ENGINE, spk=spk)


@pytest.fixture(scope="module")
def tp0():
    """The same requests through the same engine at tp=0, queued before
    its loop starts, as process 0's are."""
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    engine = port_engine.TTSEngine(api._model, **ENGINE)
    start, engine._ensure_running = engine._ensure_running, lambda: None
    try:
        handles = [engine.submit(p) for p in PROMPTS]
        start()
        audio = W._drain(handles)
    finally:
        engine.close()
    return audio, W._slots(engine)


def test_tp2_engine_serves_concurrent_requests_as_tp0(group, tp0):
    """Two concurrent requests at tp=2: process 0's audio within 1e-5 of
    tp=0's, of whole tokens; every slot's tokens on both processes equal
    tp=0's."""
    want_audio, (want_tokens, want_lens) = tp0
    got = group[0]["concurrent_audio"]
    for a, b in zip(got, want_audio):
        assert isinstance(a, np.ndarray) and a.shape == b.shape and len(a) % SCALE == 0
        np.testing.assert_allclose(a, b, atol=1e-5)
    for r in group:
        tokens, lens = r["concurrent_slots"]
        np.testing.assert_array_equal(lens, want_lens)
        for slot, n in enumerate(want_lens):
            np.testing.assert_array_equal(tokens[slot, :n], want_tokens[slot, :n])
    assert want_lens[:2].min() > 0 and group[1]["concurrent_steps"] > 0


def test_follower_ends_on_close(group):
    """Each engine's follower returns when process 0 closes it, with the
    roles as built: process 0 serves, process 1 follows."""
    assert [r["concurrent_role"] for r in group] == ["server", "follower"]
    assert [r["http_role"] for r in group] == ["server", "follower"]
    assert group[1]["refused_steps"] > 0


def test_a_request_that_cannot_stage_fails_alone(group):
    """A prompt past the cache fails on process 0 before the group hears of
    it; the request beside it is served, and both processes' slots agree."""
    good, bad = group[0]["refused_audio"]
    assert isinstance(good, np.ndarray) and len(good) > 0 and len(good) % SCALE == 0
    assert isinstance(bad, str) and "exceeds the engine's cache" in bad
    # the first prompt alone in slot 0 draws row 0 of the same draws: its tokens again
    (t_first, l_first), (t_again, l_again) = (group[0]["concurrent_slots"],
                                              group[0]["refused_slots"])
    assert l_again[0] == l_first[0] and l_again[1:].sum() == 0
    np.testing.assert_array_equal(t_again[0, :l_first[0]], t_first[0, :l_first[0]])
    for key in ("refused_slots", "http_slots"):
        (t0, l0), (t1, l1) = group[0][key], group[1][key]
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(t0, t1)


def test_http_route_answers_under_tp2(group):
    """``serving_api`` gives the engine under tp; the stdlib server on
    process 0 answers a stored speaker's POST with int16 PCM of whole
    tokens (1920 bytes a token) while process 1 follows."""
    status, data = group[0]["http"]
    assert status == 200 and len(data) > 0 and len(data) % (2 * SCALE) == 0
    assert "http" not in group[1]


def test_serving_api_and_follows_without_tp():
    """Without tp, ``serving_api`` keeps the model unless slots are asked
    for, and ``follows`` returns at once."""
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    assert port_engine.serving_api(api) is api and not port_engine.follows(api)
    served = port_engine.serving_api(api, 2)
    try:
        assert isinstance(served, port_engine.EngineAPI) and served.engine.role == "server"
        assert not port_engine.follows(served)
        with pytest.raises(RuntimeError, match="follow"):
            served.engine.follow()
    finally:
        served.close()
