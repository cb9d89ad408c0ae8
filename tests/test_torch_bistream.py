"""Bistream (streaming text in) of the port against the JAX package (tiny
config, fp32, CPU): the cursor extend (also past the cache's edge, where
the JAX package's clamped write goes wrong), the fill-token decode, the
protocol generator, ``tts(use_bistream=True)``, ``tts_stream_text``,
``Cosy2EU.stream_text``, ``resolve_backbone`` and ``load(backbone=...)``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import hift_key_chain
from torch_parity import bistream_draws_from_key, jax_tts_params, t, to_numpy, to_port

import cosyvoice2_eu_torch as port
import cosyvoice2_eu_tpu as cosy_jax
from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.frontend import frontend as port_fe
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_torch.utils.profiling import StageTimer
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.frontend import frontend as jax_fe
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.runtime import model as jax_model

CFG = jax_config.tiny_test_config()
PCFG = port_config.tiny_test_config()
LM, PLM = CFG.llm, PCFG.llm
SCALE = CFG.hift.upsample_scale * CFG.flow.token_mel_ratio  # samples per token
# hidden states: fp32 through the same layers, K/V rounded to bf16 in both
# caches (tests/test_bistream.py's tolerance)
ATOL, RTOL = 2e-4, 1e-3
AUDIO_TOL = 1e-5


@pytest.fixture(scope="module")
def lm_params():
    p = jax_llm.init_lm(jax.random.key(0), LM)
    return p, to_port(p)


@pytest.fixture(scope="module")
def params():
    return jax_tts_params(CFG, seed=0)


def _seg(ids, n_bucket, src=jax_llm.SRC_TEXT):
    a = np.zeros((2, 1, n_bucket), np.int32)
    a[0, 0, :len(ids)], a[1, 0, :len(ids)] = ids, src
    return a


def _jax_extend(jp, st, seg, n):
    return jax_llm._bistream_jits(LM, 16)[0](jp, st, jnp.asarray(seg[0]), jnp.asarray(seg[1]),
                                             jnp.asarray(n, jnp.int32))


def _port_extend(pp, st, seg, n):
    return port_llm.bs_extend(pp, PLM, st, t(seg[0]).long(), t(seg[1]).long(), n)


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(kw or dict(atol=ATOL, rtol=RTOL)))


def test_qwen3_config_matches_jax():
    assert dataclasses.asdict(port_config.qwen3_0_6b_config()) == \
        dataclasses.asdict(jax_config.qwen3_0_6b_config())


def test_bs_extend_matches_prefill_and_jax(lm_params):
    """Two cursor appends (5 then 7 tokens, 8-token buckets) equal one
    prefill of the 12 tokens and JAX's appends: last hidden state, cursor,
    and the K/V the appends wrote."""
    jp, pp = lm_params
    ids = np.random.default_rng(0).integers(2, 100, 12)
    full = port_llm.lm_prefill(pp, PLM, t(_seg(ids, 16)[0]).long(), t(_seg(ids, 16)[1]).long(),
                               torch.tensor([12]), max_gen=8)
    st_p = port_llm.bs_init(pp, PLM, max_cache=24)
    st_j = jax_llm.bs_init(jp, LM, max_cache=24)
    for part in (ids[:5], ids[5:]):
        seg = _seg(part, 8)
        st_p = _port_extend(pp, st_p, seg, len(part))
        st_j = jax_llm._bistream_jits(LM, 8)[0](jp, st_j, jnp.asarray(seg[0]),
                                                jnp.asarray(seg[1]), jnp.asarray(len(part)))
    assert st_p.cache_len == int(st_j.cache_len) == 12
    _close(st_p.last_hidden, full.last_hidden.numpy())
    _close(st_p.last_hidden, st_j.last_hidden)
    for got, want in ((st_p.kv.k, st_j.kv.k), (st_p.kv.v, st_j.kv.v)):
        _close(got[..., :12, :], np.asarray(want[..., :12, :], np.float32), atol=1e-2, rtol=1e-2)


def test_bs_extend_past_the_cache_edge(lm_params):
    """A 16-token bucket whose pad rows pass the end of a 32-slot cache (10
    tokens at cursor 20).  JAX's ``dynamic_update_slice`` clamps the write
    to slots 16-31, over four valid slots, so its result differs from the
    same appends into a 64-slot cache, where nothing is clamped.  The port
    drops only the pad rows: at 32 slots it equals JAX at 64 and one
    prefill of the 30 tokens.  A segment whose valid rows do not fit raises."""
    jp, pp = lm_params
    ids = np.random.default_rng(1).integers(2, 100, 30)
    segs = [_seg(ids[i:i + 10], 16) for i in (0, 10, 20)]
    st_p = port_llm.bs_init(pp, PLM, max_cache=32)
    st_wide = jax_llm.bs_init(jp, LM, max_cache=64)
    st_edge = jax_llm.bs_init(jp, LM, max_cache=32)
    for seg in segs:
        st_p = _port_extend(pp, st_p, seg, 10)
        st_wide = _jax_extend(jp, st_wide, seg, 10)
        st_edge = _jax_extend(jp, st_edge, seg, 10)
    assert st_p.cache_len == int(st_wide.cache_len) == 30
    _close(st_p.last_hidden, st_wide.last_hidden)
    _close(st_p.kv.k[..., :30, :], np.asarray(st_wide.kv.k[..., :30, :], np.float32),
           atol=1e-2, rtol=1e-2)
    full = port_llm.lm_prefill(pp, PLM, t(_seg(ids, 32)[0]).long(), t(_seg(ids, 32)[1]).long(),
                               torch.tensor([30]), max_gen=2)
    _close(st_p.last_hidden, full.last_hidden.numpy())
    err = np.abs(np.asarray(st_edge.last_hidden) - np.asarray(st_wide.last_hidden)).max()
    assert err > 100 * ATOL, err  # the clamped write changed JAX's result
    with pytest.raises(ValueError, match="does not fit"):
        _port_extend(pp, st_p, _seg(ids[:3], 16), 3)


def _decode_calls(jp, pp, max_cache, calls, key, prefix=24):
    """Run the same bs_decode calls in both packages after one extend of a
    prefix; each call's tokens, next fill index, stop code, cursor and
    hidden state must agree.  Returns the stop codes."""
    draws = bistream_draws_from_key(key, LM.top_k, LM.full_vocab)
    ids = np.random.default_rng(2).integers(2, 100, prefix)
    seg = _seg(ids, 32)
    st_p = _port_extend(pp, port_llm.bs_init(pp, PLM, max_cache), seg, prefix)
    st_j = jax_llm._bistream_jits(LM, 16)[0](
        jp, jax_llm.bs_init(jp, LM, max_cache)._replace(rng=key), jnp.asarray(seg[0]),
        jnp.asarray(seg[1]), jnp.asarray(prefix))
    stops = []
    for nfi, allow, cap in calls:
        nfi = st_p.n_out + nfi if nfi >= 0 else -1  # forced fills relative to n_out
        st_j, out_j, n_j, nfi_j, stop_j = jax_llm._bistream_jits(LM, 64)[1](
            jp, st_j, jnp.asarray(nfi, jnp.int32), jnp.asarray(allow), jnp.asarray(cap))
        st_p, out_p, nfi_p, stop_p = port_llm.bs_decode(pp, PLM, st_p, nfi, allow, cap, draws)
        assert out_p == [int(x) for x in np.asarray(out_j)[:int(n_j)]]
        assert (nfi_p, stop_p) == (int(nfi_j), int(stop_j))
        assert (st_p.cache_len, st_p.n_out) == (int(st_j.cache_len), int(st_j.n_out))
        assert st_p.recent.tolist() == np.asarray(st_j.recent).tolist()
        _close(st_p.last_hidden, st_j.last_hidden)
        stops.append(stop_p)
    return stops, st_p


def test_bs_decode_matches_jax(lm_params):
    """Calls as the protocol makes them: no forced fill (a sampled FILL
    stops), forced fills after 2 and after 0 tokens, EOS allowed, a
    ``max_emit`` of 3: tokens, fill index, stop code, cursor, RAS window."""
    jp, pp = lm_params
    calls = [(-1, False, 64), (2, False, 64), (0, False, 64), (-1, False, 3), (-1, True, 64),
             (-1, True, 64), (-1, False, 64), (-1, True, 64)]
    stops, _ = _decode_calls(jp, pp, 256, calls, jax.random.key(3))
    assert {0, 1, 2} <= set(stops), stops  # max_emit, FILL and EOS stops all taken


def test_bs_decode_stops_at_the_cache_cap(lm_params):
    """A 40-slot cache: decoding stops with the cursor at the last slot,
    and a call there emits nothing; as JAX."""
    jp, pp = lm_params
    calls = [(-1, False, 64)] * 3
    stops, st = _decode_calls(jp, pp, 40, calls, jax.random.key(5))
    assert st.cache_len == 39 and stops[-1] == 0


def _protocol_inputs(seed):
    rng = np.random.default_rng(seed)
    prompt_text = rng.integers(2, 200, 4).astype(np.int32)
    prompt_speech = rng.integers(0, LM.speech_token_size, 18).astype(np.int32)
    pieces = [rng.integers(2, 200, n).astype(np.int32) for n in (3, 0, 7, 2, 9, 4)]
    return prompt_text, prompt_speech, pieces


def _run_protocol(lm_params, seed, key):
    jp, pp = lm_params
    prompt_text, prompt_speech, pieces = _protocol_inputs(seed)
    want = list(jax_llm.lm_inference_bistream(jp, LM, iter(pieces), prompt_text, prompt_speech,
                                              key, max_cache=256, seg_bucket=16,
                                              chunk_capacity=16))
    timer = StageTimer()
    got = port_llm.lm_inference_bistream(
        pp, PLM, iter(pieces), prompt_text, prompt_speech,
        draws=bistream_draws_from_key(key, LM.top_k, LM.full_vocab), max_cache=256,
        seg_bucket=16, chunk_capacity=16, timer=timer)
    return got, want, timer


@pytest.mark.parametrize("seed", [1, 2])
def test_lm_inference_bistream_matches_jax(lm_params, seed):
    """The whole protocol over uneven text pieces (one empty), a prompt
    interleave that waits for text, FILL-driven extends and the final
    segment: the same tokens under JAX's draws, and 8 extends."""
    got, want, timer = _run_protocol(lm_params, seed, jax.random.key(seed))
    assert list(got) == want and len(want) > 20
    assert timer.counts["bs_extend"] == 8 and timer.counts["bs_decode"] >= 3


def test_lm_inference_bistream_raises_where_the_text_no_longer_fits(lm_params):
    """Random weights that never ask for text fill the cache on the first
    piece (decoding stops one slot short of its end); the next text extend
    cannot fit.  JAX's clamped write puts it over the last valid slots, its
    cursor passes the cache's end and the request ends without a word; the
    port yields the same tokens up to there, then raises."""
    got, want, _ = _run_protocol(lm_params, 2, jax.random.key(1))
    seen = []
    with pytest.raises(ValueError, match="does not fit a cache of 256 slots"):
        for tok in got:
            seen.append(tok)
    assert seen == want and len(seen) > 200


def _inputs(cls, seed=0, n_text=14, n_sp=6):
    rng = np.random.default_rng(seed)
    return cls(
        text_tokens=rng.integers(2, 200, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, LM.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, CFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, CFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
    )


def _assert_chunks(got, want, pm):
    assert [len(c) for c in got] == [len(c) for c in want]
    assert sum(len(c) for c in got) == pm.last_n_tokens * SCALE and pm.last_n_tokens > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=AUDIO_TOL)


def _models(params, **kw):
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None, use_bistream=True, **kw)
    pm = port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None, device="cpu",
                             use_bistream=True, **kw)
    jm._rng = jax.random.key(21)
    r1, k_lm = jax.random.split(jm._rng)
    return jm, pm, dict(lm_draws=bistream_draws_from_key(k_lm, LM.top_k, LM.full_vocab),
                        hift_draws=hift_key_chain(r1))


@pytest.mark.parametrize("stream", [False, True])
def test_tts_use_bistream_matches_jax(params, stream):
    """``tts`` under ``use_bistream`` (the text fed in 5-token pieces) in both
    packages, the LM draws from the first key JAX's ``_next_rng`` hands out
    and each HiFT call's from the next: the same chunks and audio."""
    jm, pm, draws = _models(params)
    want = list(jm.tts(_inputs(jax_model.PromptInputs), stream=stream))
    got = list(pm.tts(_inputs(port_model.PromptInputs), stream=stream, **draws))
    _assert_chunks(got, want, pm)
    assert pm.last_decode_steps >= pm.last_n_tokens
    assert pm.timer.counts["bs_extend"] >= 3 and pm.timer.counts["bs_decode"] >= 2


def test_tts_stream_text_matches_jax(params):
    """Text pieces as they arrive (one empty) through ``tts_stream_text`` on
    the recompute path: the same chunks and audio as JAX."""
    jm, pm, draws = _models(params, cached_stream=False)
    _, _, pieces = _protocol_inputs(3)
    want = list(jm.tts_stream_text(iter(pieces), _inputs(jax_model.PromptInputs, 1)))
    got = list(pm.tts_stream_text(iter(pieces), _inputs(port_model.PromptInputs, 1), **draws))
    assert len(got) >= 2
    _assert_chunks(got, want, pm)


def test_bistream_is_not_on_the_batch_and_vc_paths(params):
    """As in the JAX package, ``tts_batch``, ``vc`` and the serving engine
    ignore ``use_bistream``: under the same draws ``tts_batch`` and ``vc``
    give what the unistream model gives."""
    inputs = _inputs(port_model.PromptInputs, 2)
    a = port_model.TTSModel(PCFG, to_numpy(params), seed=3, compute_dtype=None, device="cpu",
                            use_bistream=True)
    b = port_model.TTSModel(PCFG, to_numpy(params), seed=3, compute_dtype=None, device="cpu")
    for x, y in zip(a.tts_batch([inputs]), b.tts_batch([inputs])):
        np.testing.assert_array_equal(x, y)
    src = np.arange(40) % CFG.flow.vocab_size
    np.testing.assert_array_equal(np.concatenate(list(a.vc(src, inputs))),
                                  np.concatenate(list(b.vc(src, inputs))))
    assert "bs_decode" not in a.timer.counts
    # the engine packs every request as unistream (``_pack_lm_prompt``) and
    # never reads the flag, as the JAX engine
    import inspect

    from cosyvoice2_eu_torch.serving import engine

    assert "use_bistream" not in inspect.getsource(engine)
    assert "_pack_lm_prompt" in inspect.getsource(engine.TTSEngine)


def _write_backbone(path, bb, model_type):
    cfg = {"model_type": model_type, "vocab_size": bb.vocab_size, "hidden_size": bb.hidden_size,
           "intermediate_size": bb.intermediate_size, "num_hidden_layers": bb.num_layers,
           "num_attention_heads": bb.num_heads, "num_key_value_heads": bb.num_kv_heads,
           "head_dim": bb.head_dim, "rope_theta": 10000.0}
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("model_type", ["qwen2", "qwen3"])
def test_resolve_backbone_matches_jax(tmp_path, model_type):
    path = _write_backbone(tmp_path, LM.backbone, model_type)
    for spec in (f"local:{path}", f"hf:{path}", path):
        bb_p, tok_p, bis_p = port.resolve_backbone(spec, None)
        bb_j, tok_j, bis_j = cosy_jax.resolve_backbone(spec, None)
        assert dataclasses.asdict(bb_p) == dataclasses.asdict(bb_j)
        assert (tok_p, bis_p) == (tok_j, bis_j) == (path, True)
    assert bb_p.use_qk_norm == (model_type == "qwen3")
    assert bb_p.attention_bias == (model_type == "qwen2")


def test_resolve_backbone_name_fallback_and_error():
    for spec in (None, "blanken"):
        assert port.resolve_backbone(spec) == cosy_jax.resolve_backbone(spec, None)
    bb, tok, bis = port.resolve_backbone("hf:Qwen/Qwen3-0.6B")
    assert bb == port_config.qwen3_0_6b_config() and tok is None and bis
    assert dataclasses.asdict(bb) == dataclasses.asdict(
        cosy_jax.resolve_backbone("hf:Qwen/Qwen3-0.6B", None)[0])
    for impl in (port.resolve_backbone, cosy_jax.resolve_backbone):
        with pytest.raises(ValueError, match="cannot resolve backbone"):
            impl("hf:nowhere/llama-7b", None)


@pytest.fixture(scope="module")
def qk_norm_backbone(tmp_path_factory, params):
    """A tiny qwen3-type backbone (q/k norms, no attention bias) as a local
    checkout, and the JAX package's parameters for a model on it."""
    path = _write_backbone(tmp_path_factory.mktemp("qwen3"), LM.backbone, "qwen3")
    bb = cosy_jax.resolve_backbone(f"local:{path}", None)[0]
    cfg = dataclasses.replace(CFG, llm=dataclasses.replace(LM, backbone=bb))
    return path, cfg, dict(params, llm=jax_llm.init_lm(jax.random.key(4), cfg.llm))


def _under_jax_stream_text(papi, japi, key):
    jm, pm = japi._model, papi._model
    jm._rng = key
    r1, k_lm = jax.random.split(key)
    real = pm.tts_stream_text
    pm.tts_stream_text = lambda chunks, inputs, **kw: real(
        chunks, inputs, lm_draws=bistream_draws_from_key(k_lm, LM.top_k, LM.full_vocab),
        hift_draws=hift_key_chain(r1), **kw)


def test_load_backbone_stream_text_matches_jax(qk_norm_backbone):
    """``load(backbone="local:...")`` on a tiny backbone with q/k norms: the
    config swapped into ``cfg.llm``, bistream on, and ``Cosy2EU.stream_text``
    (pieces tokenized one by one, empty ones skipped, chunks (1, t)) equal
    to JAX's under its draws, chunk for chunk."""
    path, cfg, jparams = qk_norm_backbone
    papi = port.load(config=PCFG, backbone=f"local:{path}", params=to_numpy(jparams),
                     seed=0, device="cpu", compute_dtype="float32")
    japi = cosy_jax.load(config=CFG, backbone=f"local:{path}", params=jparams, seed=0,
                         compute_dtype="float32")
    assert papi._model.use_bistream and japi._model.use_bistream
    papi._model.cached_stream = japi._model.cached_stream = False  # fewer JAX compiles
    assert papi._cfg.llm.backbone.use_qk_norm and "q_norm" in \
        papi._model.params["llm"]["backbone"]["layers"][0]
    rng = np.random.default_rng(8)
    prompt = {"prompt_feat": rng.standard_normal((12, CFG.flow.output_size)).astype(np.float32),
              "speech_tokens": rng.integers(0, LM.speech_token_size, 6).astype(np.int32),
              "embedding": rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
              "prompt_text": "salut"}
    pieces = ["Bonjour ", "", "tout le ", "monde, ", "ça va ?"]
    _under_jax_stream_text(papi, japi, jax.random.key(31))
    got = list(papi.stream_text(iter(pieces), prompt, prompt_text="salut"))
    want = list(japi.stream_text(iter(pieces), prompt, prompt_text="salut"))
    assert all(c.shape[0] == 1 for c in got)
    _assert_chunks([c[0] for c in got], [c[0] for c in want], papi._model)


def test_load_model_dir_with_a_qwen3_backbone(qk_norm_backbone, tmp_path):
    """``load(model_dir=..., backbone=...)`` converts a qwen3 ``llm.pt`` (its
    q/k norms) at the backbone's widths: the same LM parameters as the tree
    it was written from."""
    import chip_smoke
    from test_torch_checkpoint import _save_model_dir

    path, cfg, jparams = qk_norm_backbone
    model_dir = _save_model_dir(tmp_path / "md", to_numpy(jparams))
    api = port.load(config=PCFG, model_dir=model_dir, backbone=f"local:{path}", device="cpu",
                    compute_dtype="float32")
    got = chip_smoke._by_path(api._model.params["llm"])
    want = chip_smoke._by_path(to_numpy(jparams["llm"]))
    assert sorted(got) == sorted(want) and any("q_norm" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_frontend_tokenizes_each_piece(params):
    """``Cosy2EU.stream_text`` tokenizes each piece on its own (the byte
    tokenizer here): what reaches ``tts_stream_text`` is the list of
    non-empty pieces' tokens, as JAX's frontend gives them."""
    pm = port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None, device="cpu")
    api = port.Cosy2EU(pm, port_fe.Frontend(PCFG, device="cpu"), PCFG)
    seen = []

    def fake(chunks, inputs, **kw):
        seen.extend(list(c) for c in chunks)
        yield np.zeros(4, np.float32)

    pm.tts_stream_text = fake
    prompt = {"prompt_feat": np.zeros((12, 16), np.float32), "speech_tokens": np.arange(6),
              "embedding": np.ones(192, np.float32)}
    out = list(api.stream_text(iter(["ab", "", "c d"]), prompt))
    jfe = jax_fe.Frontend(CFG)
    assert seen == [list(jfe.text_tokens(s)) for s in ("ab", "c d")]
    assert [c.shape for c in out] == [(1, 4)]
