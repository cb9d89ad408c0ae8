"""The port's continuous-batching engine against the JAX package (tiny
config, fp32, CPU): the per-row decode step, slot admission and the slot
decode, the batched steady chunk over sessions at different cursors and the
batched first emission, then the engine's own behaviour (more requests than
slots, speed, loop death and restart, staging, long utterances, padded
groups) and its audio against ``StreamSession.feed``.

Every test that waits on the engine drains through ``_drain``, which gives
up after a deadline, and closes the engine in ``finally``: a request the
engine still holds when it closes fails instead of blocking its reader."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import hift_key_chain
from torch_parity import hift_draws_from_key, jax_tts_params, lm_draws_from_key, t, to_numpy

from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.models import qwen2 as port_qwen2
from cosyvoice2_eu_torch.ops.sampling import gumbel
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_torch.serving import engine as port_engine
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import flow_streaming as jax_fs
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.models import qwen2 as jax_qwen2
from cosyvoice2_eu_tpu.runtime import model as jax_model
from cosyvoice2_eu_tpu.serving.engine import StreamSession as JaxStreamSession
from cosyvoice2_eu_tpu.serving.engine import TTSEngine as JaxTTSEngine

CFG = tiny_test_config()
PCFG = port_tiny()
SCALE = CFG.hift.upsample_scale * CFG.flow.token_mel_ratio  # samples per token
HOP, LA = CFG.stream.token_hop_len, CFG.flow.pre_lookahead_len
CAP = 128  # the cached window of the parity tests' models
DEADLINE = 120.0  # seconds an engine test may wait for its audio


@pytest.fixture(scope="module")
def params():
    return jax_tts_params(CFG, seed=0)


@pytest.fixture(scope="module")
def jm(params):
    return jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None, stream_max_tokens=CAP)


@pytest.fixture(scope="module")
def pm(params):
    """The engine tests' port model (the default 768-token cached window)."""
    return _port(params)


def _port(params, **kw):
    return port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None,
                               device="cpu", **kw)


def _inputs(cls, seed, n_text=10, n_sp=6):
    rng = np.random.default_rng(seed)
    return cls(
        text_tokens=rng.integers(2, 200, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, CFG.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, CFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, CFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
    )


def _p(seed, **kw):
    return _inputs(port_model.PromptInputs, seed, **kw)


def _drain(handles, timeout=DEADLINE):
    """Each handle's chunks (or the exception its iteration raised), read in
    a worker thread that must finish within ``timeout`` seconds."""
    out = [None] * len(handles)

    def read():
        for i, h in enumerate(handles):
            try:
                out[i] = list(h)
            except RuntimeError as e:
                out[i] = e

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    assert not reader.is_alive(), f"the engine gave no end of audio within {timeout} s"
    return out


def _audio(chunks):
    assert isinstance(chunks, list) and chunks, chunks
    assert all(c.dtype == np.float32 and c.ndim == 1 for c in chunks)
    total = np.concatenate(chunks)
    assert np.isfinite(total).all() and len(total) > 0 and len(total) % SCALE == 0
    return total


# ---------------------------------------------------------------------------
# the LM's slot API
# ---------------------------------------------------------------------------


def test_decode_step_at_per_row_slots_matches_jax(params):
    """``qwen2_decode_step`` with a (B,) cache index: each row writes its K/V
    at its own slot and attends over the whole cache under its mask; hidden
    and the whole cache, atol 1e-5."""
    bcfg = CFG.llm.backbone
    rng = np.random.default_rng(0)
    b, max_cache = 3, 40
    shape = (bcfg.num_layers, b, bcfg.num_kv_heads, max_cache, bcfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    embed = rng.standard_normal((b, bcfg.hidden_size)).astype(np.float32)
    write_at = np.asarray([5, 17, 33], np.int32)
    rope_pos = np.asarray([5, 30, 12], np.int32)
    visible = np.arange(max_cache)[None] <= write_at[:, None]
    visible[1, 2:9] = False  # a pad gap, as between a prompt and its bucket
    h_j, kv_j = jax_qwen2.qwen2_decode_step(
        params["llm"]["backbone"], bcfg, jnp.asarray(embed), jnp.asarray(rope_pos),
        jnp.asarray(write_at), jnp.asarray(visible), jax_qwen2.KVCache(jnp.asarray(k),
                                                                       jnp.asarray(v)))
    pp = _port(params).params["llm"]["backbone"]
    kv_p = port_qwen2.KVCache(t(k), t(v))
    h_p, kv_p = port_qwen2.qwen2_decode_step(pp, PCFG.llm.backbone, t(embed), t(rope_pos).long(),
                                             t(write_at).long(), t(visible), kv_p)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(kv_p.k.numpy(), np.asarray(kv_j.k), atol=1e-5)
    np.testing.assert_allclose(kv_p.v.numpy(), np.asarray(kv_j.v), atol=1e-5)


SLOT_FIELDS = ("tokens", "recent", "lengths", "finished", "active", "gen_step", "base",
               "prompt_len", "min_len", "max_len")


def _same_slots(got, want):
    """Every field of a port ``SlotState`` against a JAX one: KV and
    ``last_hidden`` atol 1e-5, the integer fields exactly."""
    np.testing.assert_allclose(got.kv.k.numpy(), np.asarray(want.kv.k), atol=1e-5)
    np.testing.assert_allclose(got.kv.v.numpy(), np.asarray(want.kv.v), atol=1e-5)
    np.testing.assert_allclose(got.last_hidden.numpy(), np.asarray(want.last_hidden), atol=1e-5)
    for f in SLOT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("admit", ["slot_prefill", "prefill_row+slot_insert"])
def test_slot_admission_matches_jax(params, admit):
    """A request admitted into slot 1 of two: by ``slot_prefill``, or by
    ``prefill_row`` then ``slot_insert``; every field equals JAX's, and the
    two ways give the same state."""
    cfg, max_cache, max_gen = CFG.llm, 128, 64
    jp = params["llm"]
    pp = _port(params).params["llm"]
    ids, src, prompt_len, p_bucket, min_len, max_len = _port(params)._pack_lm_prompt(_p(5))
    j_init = jax_llm.slots_init(cfg, 2, max_cache, max_gen, jax.random.key(3), dtype=jnp.float32)
    p_init = port_llm.slots_init(PCFG.llm, 2, max_cache, max_gen, dtype=torch.float32)
    if admit == "slot_prefill":
        want = jax_llm.slot_prefill(jp, cfg, j_init, jnp.asarray(1), jnp.asarray(ids),
                                    jnp.asarray(src), jnp.asarray(prompt_len),
                                    jnp.asarray(min_len), jnp.asarray(max_len))
        got = port_llm.slot_prefill(pp, PCFG.llm, p_init, 1, t(ids).long(), t(src).long(),
                                    prompt_len, min_len, max_len)
    else:
        row, last = jax_llm.prefill_row(jp, cfg, jnp.asarray(ids), jnp.asarray(src),
                                        jnp.asarray(prompt_len), max_cache, jnp.float32)
        want = jax_llm.slot_insert(j_init, jnp.asarray(1), row, last, jnp.asarray(prompt_len),
                                   jnp.asarray(min_len), jnp.asarray(max_len),
                                   jnp.asarray(p_bucket))
        p_row, p_last = port_llm.prefill_row(pp, PCFG.llm, t(ids).long(), t(src).long(),
                                             prompt_len, max_cache, torch.float32)
        got = port_llm.slot_insert(p_init, 1, p_row, p_last, prompt_len, min_len, max_len,
                                   p_bucket)
    _same_slots(got, want)
    other = port_llm.slot_prefill(
        pp, PCFG.llm, port_llm.slots_init(PCFG.llm, 2, max_cache, max_gen, dtype=torch.float32),
        1, t(ids).long(), t(src).long(), prompt_len, min_len, max_len)
    _same_slots(got, _as_jax_like(other))


def _as_jax_like(state):
    """A port ``SlotState`` as an object with numpy fields (for ``_same_slots``)."""
    return SimpleNamespace(kv=SimpleNamespace(k=state.kv.k.numpy(), v=state.kv.v.numpy()),
                           last_hidden=state.last_hidden.numpy(),
                           **{f: getattr(state, f).numpy() for f in SLOT_FIELDS})


def test_slots_decode_matches_jax(params):
    """Three slots: slot 0 decodes long, slot 1 stays empty, slot 2 finishes
    early on its ``max_len`` of 10 in the second call.  Two calls of 8
    steps under JAX's key, its chain carried across them by the port's step
    counter: tokens, lengths and ``finished`` equal after each call."""
    cfg, max_cache, max_gen, n_slots = CFG.llm, 128, 64, 3
    jp, pm = params["llm"], _port(params)
    pp = pm.params["llm"]
    key = jax.random.key(1)
    j_state = jax_llm.slots_init(cfg, n_slots, max_cache, max_gen, key, dtype=jnp.float32)
    p_state = port_llm.slots_init(PCFG.llm, n_slots, max_cache, max_gen, dtype=torch.float32)
    for slot, seed, max_len in ((0, 0, 48), (2, 1, 10)):
        ids, src, prompt_len, _, min_len, _ = pm._pack_lm_prompt(_p(seed))
        j_state = jax_llm.slot_prefill(jp, cfg, j_state, jnp.asarray(slot), jnp.asarray(ids),
                                       jnp.asarray(src), jnp.asarray(prompt_len),
                                       jnp.asarray(min_len), jnp.asarray(max_len))
        p_state = port_llm.slot_prefill(pp, PCFG.llm, p_state, slot, t(ids).long(),
                                        t(src).long(), prompt_len, min_len, max_len)
    draws = lm_draws_from_key(key, n_slots, 16, cfg.top_k, cfg.full_vocab)
    for call in (1, 2):
        j_state = jax_llm.slots_decode(jp, cfg, j_state, 8)
        p_state = port_llm.slots_decode(pp, PCFG.llm, p_state, 8, draws)
        assert p_state.step == 8 * call
        for f in ("tokens", "lengths", "finished"):
            np.testing.assert_array_equal(getattr(p_state, f).numpy(),
                                          np.asarray(getattr(j_state, f)), err_msg=f"{f} {call}")
    lengths, finished = p_state.lengths.tolist(), p_state.finished.tolist()
    assert lengths[1] == 0 and not finished[1]  # the empty slot never ran
    assert lengths[2] == 10 and finished[2] and not finished[0]


def test_slot_decode_matches_lm_decode(params):
    """A request decoded in slot 1 of two gives ``lm_decode``'s tokens on
    the same prompt, given that row's draws (the slot's KV cache in bf16,
    as ``lm_decode``'s; its row one slot longer than ``lm_decode``'s cache,
    so the cache guard cannot end it first)."""
    pm = _port(params)
    pp, cfg, max_gen = pm.params["llm"], PCFG.llm, 64
    ids, src, prompt_len, p_bucket, min_len, max_len = pm._pack_lm_prompt(_p(3))
    g = torch.Generator().manual_seed(0)
    noise = [(gumbel((2, cfg.top_k), g), gumbel((2, cfg.full_vocab), g)) for _ in range(max_gen)]
    state = port_llm.slots_init(cfg, 2, p_bucket + max_gen + 1, max_gen, dtype=torch.float32)
    state.kv = port_qwen2.KVCache.zeros(cfg.backbone, 2, p_bucket + max_gen + 1, device="cpu")
    state = port_llm.slot_prefill(pp, cfg, state, 1, t(ids).long(), t(src).long(), prompt_len,
                                  min_len, max_len)
    state = port_llm.slots_decode(pp, cfg, state, max_gen, lambda s: noise[s])
    tokens, lengths, _ = port_llm.lm_decode(
        pp, cfg, t(ids).long(), t(src).long(), torch.tensor([prompt_len]),
        torch.tensor([min_len]), torch.tensor([max_len]), max_gen,
        draws=lambda s: (noise[s][0][1:2], noise[s][1][1:2]))
    n = int(lengths[0])
    assert n >= min_len and int(state.lengths[1]) == n
    np.testing.assert_array_equal(state.tokens[1, :n].numpy(), tokens[0, :n].numpy())


# ---------------------------------------------------------------------------
# the batched first and steady chunks
# ---------------------------------------------------------------------------


def _state_leaves(state):
    out = [(f, getattr(state, f)) for f in ("pre_k", "pre_v", "lookahead_tail",
                                            "up_conv_tail", "up_k", "up_v", "est_h")]
    return out + sorted((f"conv_tails/{k}", v) for k, v in state.conv_tails.items())


def _to_jax_state(st):
    return jax_fs.FlowStreamState(
        **{f: jnp.asarray(v.numpy()) for f, v in _state_leaves(st) if "/" not in f},
        conv_tails={k: jnp.asarray(v.numpy()) for k, v in st.conv_tails.items()},
        t_tok=jnp.asarray(st.t_tok, jnp.int32), t_mel=jnp.asarray(st.t_mel, jnp.int32))


def _same_state(got, want, atol=1e-4, what=""):
    assert (got.t_tok, got.t_mel) == (int(want.t_tok), int(want.t_mel)), what
    for (name, g), (_, w) in zip(_state_leaves(got), _state_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=f"{what} {name}")


def _session_state(pm, n_chunks, rng):
    """A flow state fed ``n_chunks`` hops of random tokens (cursor n_chunks x 25)."""
    st = pm._init_stream_state()
    tokens = rng.integers(0, CFG.flow.vocab_size, n_chunks * HOP + LA).astype(np.int32)
    xvec = rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32)
    cond = np.zeros((2 * HOP, CFG.flow.output_size), np.float32)
    for c in range(n_chunks):
        o = c * HOP
        _, st = pm._flow_feed(st, tokens[o:o + HOP], tokens[o + HOP:o + HOP + LA], cond, xvec)
    return st


def test_stream_chunk_batch_matches_jax(params, jm):
    """``_stream_chunk_batch`` over two sessions at cursors 50 and 75, padded
    to 4 rows with the empty state, against JAX's
    ``_stream_chunk_fused_batch_fn`` under its HiFT key: every row's state
    (atol 1e-4), audio and caches (atol 1e-3).  Each real row also equals
    its session's own steady chunk (``flow_chunk`` + ``_hift_chunk``) given
    that row's draws."""
    pm = _port(params, stream_max_tokens=CAP)
    rng = np.random.default_rng(0)
    states = [_session_state(pm, n, rng) for n in (2, 3)] + [pm._init_stream_state()] * 2
    b, mc, sc = 4, pm.mel_cache_len, pm.source_cache_len
    tok = rng.integers(0, CFG.flow.vocab_size, (b, HOP)).astype(np.int32)
    ctx = rng.integers(0, CFG.flow.vocab_size, (b, LA)).astype(np.int32)
    emb = rng.standard_normal((b, CFG.frontend.spk_embed_dim)).astype(np.float32)
    cond = np.zeros((b, 2 * HOP, CFG.flow.output_size), np.float32)
    c_mel = rng.standard_normal((b, CFG.flow.output_size, mc)).astype(np.float32)
    c_src = (0.1 * rng.standard_normal((b, 1, sc))).astype(np.float32)
    c_sp = (0.1 * rng.standard_normal((b, sc))).astype(np.float32)
    tok[2:], ctx[2:], emb[2:] = tok[0], ctx[0], emb[0]  # pad rows repeat row 0, empty caches
    c_mel[2:], c_src[2:], c_sp[2:] = 0.0, 0.0, 0.0
    key = jax.random.key(11)
    drawn = []

    def draws(*shape):  # JAX's draws from ``key``, kept for the per-row check
        drawn.append(hift_draws_from_key(key)(*shape))
        return drawn[-1]

    fused = jm._stream_chunk_fused_batch_fn(HOP, b)
    w_states, w_audio, w_mel, w_src, w_sp = fused(
        jm._get_stream_params(), tuple(_to_jax_state(s) for s in states), *map(
            jnp.asarray, (tok, ctx, emb, cond)), jm.params["hift"], key,
        *map(jnp.asarray, (c_mel, c_src, c_sp)))
    got_states, audio, g_mel, g_src, g_sp = pm._stream_chunk_batch(
        HOP, states, tok, ctx, emb, cond, t(c_mel), t(c_src), c_sp,
        hift_draws=draws)
    assert [s.t_tok for s in got_states] == [75, 100, 25, 25]
    for i in range(b):
        _same_state(got_states[i], w_states[i], what=f"row {i}")
        assert audio[i].dtype == np.float32
        np.testing.assert_allclose(audio[i], np.asarray(w_audio[i]), atol=1e-3)
    np.testing.assert_allclose(g_mel.numpy(), np.asarray(w_mel), atol=1e-4)
    np.testing.assert_allclose(g_src.numpy(), np.asarray(w_src), atol=1e-3)
    np.testing.assert_allclose(g_sp, np.asarray(w_sp), atol=1e-3)
    assert len(audio[0]) == (mc + 2 * HOP) * CFG.hift.upsample_scale - sc

    (rand_ini, noise), = drawn
    for i in range(2):
        mel, st = pm._flow_feed(states[i].clone(), tok[i], ctx[i], cond[i], emb[i])
        session = {"hift_cache": {"mel": t(c_mel[i:i + 1]), "source": t(c_src[i:i + 1]),
                                  "speech": c_sp[i]}}
        want = pm._hift_chunk(mel, session, False, hift_draws=lambda *_, i=i: (
            rand_ini[i:i + 1], noise[i:i + 1]))
        np.testing.assert_allclose(audio[i], want, atol=1e-5)
        _same_state(got_states[i], _to_jax_state(st), atol=1e-5, what=f"own feed {i}")


def test_first_batch_matches_jax(params, jm):
    """``_first_batch`` over two sessions in slots 0 and 2 of a 4-slot
    engine (their first chunks of 44 + 3 tokens, one flow recompute and one
    HiFT call on 4 rows): each session's audio (atol 1e-3), its primed
    vocoder cache, its cached flow state (atol 1e-4) and its counters equal
    JAX's."""
    pm = _port(params, stream_max_tokens=CAP)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, CFG.llm.speech_token_size, (4, 64)).astype(np.int64)
    lengths = np.asarray([50, 0, 60, 0])
    key = jax.random.key(5)
    jm._rng = key
    j_eng = JaxTTSEngine(jm, n_slots=4, chunk_steps=16, max_cache=256, max_gen=64)
    p_eng = port_engine.TTSEngine(pm, n_slots=4, chunk_steps=16, max_cache=256, max_gen=64,
                                  hift_draws=hift_key_chain(key))
    j_group = [(s, SimpleNamespace(session=JaxStreamSession(
        jm, _inputs(jax_model.PromptInputs, seed)))) for s, seed in ((0, 20), (2, 21))]
    p_group = [(s, SimpleNamespace(session=port_engine.StreamSession(
        pm, _p(seed), hift_draws=p_eng.hift_draws))) for s, seed in ((0, 20), (2, 21))]
    assert all(r.session.first_ready(tokens[s, :lengths[s]]) for s, r in p_group)
    want = j_eng._first_batch(j_group, tokens.astype(np.int32), lengths)
    got = p_eng._first_batch(p_group, tokens, lengths)
    assert pm.timer.counts["flow"] == 1 and pm.timer.counts["hift"] == 1
    for i, ((_, jr), (_, pr)) in enumerate(zip(j_group, p_group)):
        js, ps = jr.session, pr.session
        assert got[i].dtype == np.float32 and len(got[i]) == len(want[i])
        np.testing.assert_allclose(got[i], want[i], atol=1e-3)
        for f in ("t_fed", "emitted", "this_hop", "next_feed", "first_pending"):
            assert getattr(ps, f) == getattr(js, f), f
        jc, pc = js.session["hift_cache"], ps.session["hift_cache"]
        np.testing.assert_allclose(pc["mel"].numpy(), np.asarray(jc["mel"]), atol=1e-4)
        np.testing.assert_allclose(pc["source"].numpy(), np.asarray(jc["source"]), atol=1e-3)
        np.testing.assert_allclose(pc["speech"], np.asarray(jc["speech"]), atol=1e-3)
        _same_state(ps.fstate, js.fstate, what=f"session {i}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_more_requests_than_slots(pm):
    """4 requests on 2 slots: every request ends with finite audio of whole
    tokens; a slot is reused."""
    engine = port_engine.TTSEngine(pm, n_slots=2, chunk_steps=16, max_cache=256, max_gen=64)
    try:
        outs = _drain([engine.submit(_p(10 + i)) for i in range(4)])
    finally:
        engine.close()
    for chunks in outs:
        _audio(chunks)


def test_engine_speed_single_shot(pm):
    """``speed != 1.0`` renders the flow and HiFT once, at the end (one
    chunk), with the mel stretched: a whole number of frames."""
    engine = port_engine.TTSEngine(pm, n_slots=1, chunk_steps=16, max_cache=256, max_gen=64)
    try:
        (chunks,) = _drain([engine.submit(_p(99), speed=1.25)])
    finally:
        engine.close()
    assert len(chunks) == 1 and len(chunks[0]) % CFG.hift.upsample_scale == 0
    assert np.isfinite(chunks[0]).all() and len(chunks[0]) > 0


def test_engine_loop_death_fails_requests_and_recovers(pm):
    """A failure in the loop fails every request it holds (no reader blocks),
    drops the running flag, and the next submit restarts the loop on empty
    slots."""
    engine = port_engine.TTSEngine(pm, n_slots=1, chunk_steps=16, max_cache=256, max_gen=64)
    try:
        real = engine._decode

        def dying():
            raise RuntimeError("injected backend death")

        engine._decode = dying
        (out,) = _drain([engine.submit(_p(7))])
        assert isinstance(out, RuntimeError) and "engine loop died" in str(out)
        engine._thread.join(timeout=10)
        assert not engine._thread.is_alive() and not engine._running
        assert engine.state.step == 0 and not bool(engine.state.active.any())
        engine._decode = real
        (chunks,) = _drain([engine.submit(_p(8))])
        _audio(chunks)
    finally:
        engine.close()


def test_engine_stages_while_slots_busy(pm):
    """With 1 slot and 3 requests, a request is prefilled and staged while
    the slot is busy."""
    engine = port_engine.TTSEngine(pm, n_slots=1, chunk_steps=4, max_cache=256, max_gen=64)
    try:
        handles = [engine.submit(_p(20 + i)) for i in range(3)]
        saw_staged = False
        t0 = time.time()
        while time.time() - t0 < DEADLINE and not saw_staged:
            saw_staged = len(engine._staged) >= 1 and engine._slots[0] is not None
            time.sleep(0.005)
        outs = _drain(handles)
    finally:
        engine.close()
    assert saw_staged, "no request was staged while the slot was busy"
    for chunks in outs:
        _audio(chunks)


def test_engine_long_utterance_past_the_flow_bucket(pm, monkeypatch):
    """A request whose prompt and tokens pass the largest flow bucket (cut
    to 128 tokens) streams to its end through the windowed finalize."""
    monkeypatch.setattr(port_model, "FLOW_TOKEN_BUCKETS", (64, 128))
    engine = port_engine.TTSEngine(pm, n_slots=1, chunk_steps=16, max_cache=320, max_gen=150)
    try:
        (chunks,) = _drain([engine.submit(_p(77, n_text=90))])  # min_len 180: 150 tokens
    finally:
        engine.close()
    assert len(_audio(chunks)) == 150 * SCALE


def test_engine_forms_padded_groups(pm):
    """2 requests on 4 slots of 128 tokens each: their first emissions run
    as one batched recompute and their steady chunks as batched rounds, each
    group padded to 4 rows, and every token is vocoded once.  A second wave
    reuses the pad state."""
    engine = port_engine.TTSEngine(pm, n_slots=4, chunk_steps=16, max_cache=320, max_gen=128)
    pm.timer.reset()
    try:
        for wave in (0, 1):
            # 70 text tokens: min_len 140, so each decodes to max_gen
            outs = _drain([engine.submit(_p(60 + 2 * wave + i, n_text=70)) for i in range(2)])
            for chunks in outs:
                assert len(_audio(chunks)) == 128 * SCALE
    finally:
        engine.close()
    counts = pm.timer.counts
    assert counts["eng_first_batch"] >= 2 and counts["eng_steady_batch"] >= 2, dict(counts)


def test_engine_audio_equals_stream_session_feed(pm, monkeypatch):
    """With one slot and injected draws, an engine request's audio equals
    ``StreamSession.feed`` over the tokens the engine decoded, fed at once."""
    def hift_draws():
        g = torch.Generator().manual_seed(3)
        return lambda b, length, h: (torch.rand((b, h), generator=g),
                                     torch.randn((b, length, h), generator=g))

    lm_draws = port_llm.generator_draws(torch.Generator().manual_seed(4), 1, PCFG.llm)
    engine = port_engine.TTSEngine(pm, n_slots=1, chunk_steps=16, max_cache=256, max_gen=128,
                                   lm_draws=lm_draws, hift_draws=hift_draws())
    fed = []
    inner = port_engine.StreamSession.feed

    def feed(self, gen, lm_finished):
        fed.append(np.asarray(gen).copy())
        return inner(self, gen, lm_finished)

    prompt = _p(31, n_text=40)  # min_len 80: past the first chunk and into steady ones
    monkeypatch.setattr(port_engine.StreamSession, "feed", feed)
    try:
        (chunks,) = _drain([engine.submit(prompt)])
    finally:
        engine.close()
    tokens = fed[-1]
    assert len(fed) >= 3 and len(tokens) >= 80
    want = port_engine.StreamSession(pm, prompt, hift_draws=hift_draws()).feed(tokens, True)
    np.testing.assert_array_equal(np.concatenate(chunks), np.concatenate(want))
    assert len(np.concatenate(chunks)) == len(tokens) * SCALE
