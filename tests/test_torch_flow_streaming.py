"""Parity of the port's chunk-cached streaming flow with the JAX package
(tiny config, fp32, CPU): the cached primitives, the rel-pos tables, a
sequence of ``flow_chunk`` calls with their state, and the cached mel against
the port's own full-prefix recompute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t, to_port

from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import flow as port_flow
from cosyvoice2_eu_torch.models import flow_streaming as port_fs
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import flow as jax_flow
from cosyvoice2_eu_tpu.models import flow_streaming as jax_fs

CFG = tiny_test_config().flow
PCFG = port_tiny().flow
HOP = CFG.encoder.static_chunk_size  # 25 tokens
LA = CFG.pre_lookahead_len  # 3
T_TOK_MAX = 128


@pytest.fixture(scope="module")
def params():
    p = jax_flow.init_flow(jax.random.key(3), CFG)
    return p, to_port(p)


@pytest.fixture(scope="module")
def stream_params(params):
    jp, pp = params
    return (jax_fs.prepare_stream_params(jp, CFG, T_TOK_MAX),
            port_fs.prepare_stream_params(pp, PCFG, T_TOK_MAX))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dilation", [1, 2])
def test_causal_conv_cached_matches_jax(params, dilation):
    """A causal conv over a chunk and its tail, and the new tail: fp32, atol 1e-5."""
    jp, pp = params
    rng = np.random.default_rng(0)
    conv_j = jp["estimator"]["down"]["conv"]
    conv_p = pp["estimator"]["down"]["conv"]
    c = conv_j["weight"].shape[1]
    x, tail = _rand(rng, 2, c, 7), _rand(rng, 2, c, 2 * dilation)
    y_j, tail_j = jax_fs.causal_conv_cached(conv_j, jnp.asarray(x), jnp.asarray(tail), dilation)
    y_p, tail_p = port_fs.causal_conv_cached(conv_p, t(x), t(tail), dilation)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_array_equal(tail_p.numpy(), np.asarray(tail_j))


@pytest.mark.parametrize("t0,n,chunk", [(0, 25, 25), (25, 25, 25), (40, 10, 50), (0, 7, 4)])
def test_chunk_mask_matches_jax(t0, n, chunk):
    np.testing.assert_array_equal(port_fs._chunk_mask(t0, n, 96, chunk).numpy(),
                                  np.asarray(jax_fs._chunk_mask(t0, n, 96, chunk)))


def test_attn_cached_matches_jax():
    """Cache write at t0 and the masked attention over every slot (fp32 scores
    plus NEG_INF, probabilities in the input dtype): atol 1e-5."""
    rng = np.random.default_rng(1)
    b, h, n, tmax, d, t0 = 2, 3, 5, 16, 8, 6
    q, k, v = (_rand(rng, b, h, n, d) for _ in range(3))
    kc, vc = _rand(rng, b, h, tmax, d), _rand(rng, b, h, tmax, d)
    mask = np.broadcast_to(np.asarray(jax_fs._chunk_mask(t0, n, tmax, 4))[None], (b, n, tmax))
    out_j, kc_j, vc_j = jax_fs.attn_cached(*map(jnp.asarray, (q, k, v, kc, vc)), t0,
                                           jnp.asarray(mask), 0.3)
    kc_p, vc_p = t(kc), t(vc)
    out_p, kc_p2, vc_p2 = port_fs.attn_cached(t(q), t(k), t(v), kc_p, vc_p, t0,
                                              torch.tensor(mask.copy()), 0.3)
    assert kc_p2 is kc_p and vc_p2 is vc_p  # written in place
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_array_equal(kc_p.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_p.numpy(), np.asarray(vc_j))


@pytest.mark.parametrize("t0", [0, 9, 20])
def test_rel_bd_cached_matches_jax(t0):
    """The full-offset product and the gather on clipped indices: atol 1e-5."""
    rng = np.random.default_rng(2)
    b, h, n, dk, tmax = 1, 4, 6, 16, 32
    q_v, ptab = _rand(rng, b, h, n, dk), _rand(rng, 2 * tmax - 1, h, dk)
    want = jax_fs._rel_bd_cached(jnp.asarray(q_v), jnp.asarray(ptab), t0, tmax)
    got = port_fs._rel_bd_cached(t(q_v), t(ptab), t0, tmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conformer_layer_cached_matches_jax(params, stream_params):
    """One cached rel-pos conformer block at t0 = 25 over a cache holding
    history: output and the cache written in place, atol 1e-5."""
    jp, pp = params
    sj, sp = stream_params
    enc = CFG.encoder
    rng = np.random.default_rng(3)
    n, t0, dk = 25, 25, enc.output_size // enc.attention_heads
    x = _rand(rng, 1, n, enc.output_size)
    ck, cv = (_rand(rng, 1, enc.attention_heads, T_TOK_MAX, dk) for _ in range(2))
    mask = np.asarray(jax_fs._chunk_mask(t0, n, T_TOK_MAX, enc.static_chunk_size))[None]
    x_j, ck_j, cv_j = jax_fs.conformer_layer_cached(
        jp["encoder"]["encoders"][0], enc.attention_heads, jnp.asarray(x), sj["_ptab_pre"][0],
        jnp.asarray(ck), jnp.asarray(cv), t0, jnp.asarray(mask))
    ck_p, cv_p = t(ck), t(cv)
    x_p, _, _ = port_fs.conformer_layer_cached(
        pp["encoder"]["encoders"][0], enc.attention_heads, t(x), sp["_ptab_pre"][0], ck_p, cv_p,
        t0, torch.tensor(mask))
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=1e-5)
    np.testing.assert_allclose(ck_p.numpy(), np.asarray(ck_j), atol=1e-5)
    np.testing.assert_allclose(cv_p.numpy(), np.asarray(cv_j), atol=1e-5)


def test_prepare_stream_params_tables_match_jax(stream_params):
    """Rel-pos projection tables of both conformer stacks: atol 1e-5."""
    sj, sp = stream_params
    for name in ("_ptab_pre", "_ptab_up"):
        assert len(sp[name]) == len(sj[name])
        for got, want in zip(sp[name], sj[name]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _state_leaves(state):
    """(name, array) of every tensor of a FlowStreamState (either package)."""
    out = [(f, getattr(state, f)) for f in ("pre_k", "pre_v", "lookahead_tail",
                                            "up_conv_tail", "up_k", "up_v", "est_h")]
    return out + sorted((f"conv_tails/{k}", v) for k, v in state.conv_tails.items())


def _chunks(rng, n_chunks):
    total = HOP * n_chunks + LA
    tokens = rng.integers(0, CFG.vocab_size, (1, total)).astype(np.int32)
    xvec = _rand(rng, 1, CFG.spk_embed_dim)
    feat = np.zeros((1, total * 2, CFG.output_size), np.float32)
    feat[0, :30] = _rand(rng, 30, CFG.output_size)  # a 15-token prompt mel
    return tokens, xvec, feat


def test_init_flow_stream_state_matches_jax():
    """Shapes, dtypes and bytes of a session's caches; the meta device sizes
    one without allocating it."""
    st_j = jax_fs.init_flow_stream_state(CFG, T_TOK_MAX, dtype=jnp.float32)
    st_p = port_fs.init_flow_stream_state(PCFG, T_TOK_MAX, dtype=torch.float32)
    for (name, got), (_, want) in zip(_state_leaves(st_p), _state_leaves(st_j)):
        assert tuple(got.shape) == want.shape, name
    assert st_p.t_tok == 0 and st_p.t_mel == 0
    want_bytes = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(st_j))
    assert st_p.nbytes() + 2 * 4 == want_bytes  # JAX also counts its two int32 counters
    meta = port_fs.init_flow_stream_state(PCFG, T_TOK_MAX, dtype=torch.float32, device="meta")
    assert meta.nbytes() == st_p.nbytes()


def test_flow_chunk_sequence_matches_jax(params, stream_params):
    """Three chunks (the first over prompt mel), each chunk's mel and then
    every cache of the state: fp32 through the encoder and 10 Euler steps,
    atol 1e-4."""
    sj, sp = stream_params
    tokens, xvec, feat = _chunks(np.random.default_rng(4), 3)
    st_j = jax_fs.init_flow_stream_state(CFG, T_TOK_MAX, dtype=jnp.float32)
    st_p = port_fs.init_flow_stream_state(PCFG, T_TOK_MAX, dtype=torch.float32)
    chunk_j = jax.jit(jax_fs.flow_chunk, static_argnums=1)
    for c in range(3):
        o = c * HOP
        args = (tokens[:, o:o + HOP], tokens[:, o + HOP:o + HOP + LA], xvec,
                feat[:, 2 * o:2 * (o + HOP)])
        mel_j, st_j = chunk_j(sj, CFG, st_j, *map(jnp.asarray, args))
        mel_p, st_p = port_fs.flow_chunk(sp, PCFG, st_p, t(args[0]).long(), t(args[1]).long(),
                                         t(args[2]), t(args[3]))
        assert mel_p.dtype == torch.float32
        np.testing.assert_allclose(mel_p.numpy(), np.asarray(mel_j), atol=1e-4,
                                   err_msg=f"chunk {c}")
    assert (st_p.t_tok, st_p.t_mel) == (int(st_j.t_tok), int(st_j.t_mel)) == (3 * HOP, 6 * HOP)
    for (name, got), (_, want) in zip(_state_leaves(st_p), _state_leaves(st_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=name)


def test_cached_equals_recompute(params, stream_params):
    """The cached chunks reproduce the port's full-prefix recompute
    (``flow_inference(streaming=True, finalize=False)`` over every token so
    far), chunk by chunk: fp32, atol 1e-4, as the JAX package's own test."""
    _, pp = params
    _, sp = stream_params
    tokens, xvec, _ = _chunks(np.random.default_rng(5), 3)
    state = port_fs.init_flow_stream_state(PCFG, T_TOK_MAX, dtype=torch.float32)
    for c in range(3):
        o = c * HOP
        got, state = port_fs.flow_chunk(
            sp, PCFG, state, t(tokens[:, o:o + HOP]).long(),
            t(tokens[:, o + HOP:o + HOP + LA]).long(), t(xvec),
            torch.zeros((1, 2 * HOP, CFG.output_size)))
        upto = o + HOP + LA
        mel = port_flow.flow_inference(
            pp, PCFG, t(tokens[:, :upto]).long(), torch.tensor([upto]),
            torch.zeros((1, 8, CFG.output_size)), torch.tensor([0]), t(xvec),
            streaming=True, finalize=False)
        np.testing.assert_allclose(got.numpy(), mel.numpy()[:, :, 2 * o:2 * (o + HOP)],
                                   atol=1e-4, err_msg=f"chunk {c}")


def test_state_clone_is_deep():
    """A snapshot survives chunks that update the state it was taken from."""
    st = port_fs.init_flow_stream_state(PCFG, 32, dtype=torch.float32)
    snap = st.clone()
    for a in st.tensors():
        a.fill_(1.0)
    st.t_tok = 5
    assert all(float(a.abs().sum()) == 0.0 for a in snap.tensors()) and snap.t_tok == 0
