"""Tensor-parallel LM decode in the port (``parallel/tp.py``, the reductions
in ``models/qwen2.py``, the gathered speech head in ``models/llm.py``,
``TTSModel(tp=N)``) against the JAX package's GSPMD layout on the CPU.

The spec rule mirrors ``tests/test_tp.py``, with the port's head-aligned
attention on top.  The decodes run in a gloo group of 2 processes
(``tests/torch_dist_workers.py``); JAX shards on ``conftest.py``'s
simulated devices.  Tolerances: tokens equal under the same Gumbel draws;
fp32 prefill hidden states within 1e-5 (as ``test_tp.py``'s sharded
prefill, the row-parallel sums in another order); audio of
``TTSModel(tp=2)`` within 1e-5 of ``tp=0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as W
from torch_parity import lm_draws_from_key, to_numpy

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.models import llm as port_llm
from cosyvoice2_eu_torch.parallel import tp as port_tp
from cosyvoice2_eu_torch.utils.params import cast_floating, tree_map
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.parallel import tp as jax_tp
from cosyvoice2_eu_tpu.utils.params import quantize_lm_params as jax_quantize

JCFG, PCFG = jax_config.tiny_test_config(), port_config.tiny_test_config()


def _specs_as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _specs_as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs_as_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("tp", [2, 4, 64])
@pytest.mark.parametrize("quant", [False, True])
def test_spec_rule_equals_jax(tp, quant):
    """Without head counts the port's rule is JAX's, leaf for leaf (fp32
    and int8 trees), as ``test_tp.py`` pins it: q/o/down/head split, norms
    and embeddings whole, an indivisible k/v whole."""
    jp = jax_llm.init_lm(jax.random.key(0), JCFG.llm)
    if quant:
        jp = jax_quantize(jp)
    got = port_tp.lm_tp_specs(tree_map(torch.tensor, to_numpy(jp)), tp)
    assert got == _specs_as_tuples(jax_tp.lm_tp_specs(jp, tp))
    if tp == 2 and not quant:
        layer = got["backbone"]["layers"][0]
        assert layer["q_proj"]["weight"] == ("tp", None)
        assert layer["o_proj"]["weight"] == layer["down_proj"]["weight"] == (None, "tp")
        assert got["llm_decoder"]["bias"] == ("tp",)
        assert layer["input_layernorm"]["weight"] == got["backbone"]["embed_tokens"]["weight"] == ()
    if tp == 64:
        assert got["backbone"]["layers"][0]["k_proj"]["weight_q" if quant else "weight"] == ()


def _layer_shapes(cfg):
    """A parameter tree of the published widths' shapes (meta tensors)."""
    bb = cfg.backbone
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    q, kv = bb.num_heads * bb.head_dim, bb.num_kv_heads * bb.head_dim
    layer = {"q_proj": {"weight": m(q, bb.hidden_size), "bias": m(q)},
             "k_proj": {"weight": m(kv, bb.hidden_size), "bias": m(kv)},
             "v_proj": {"weight": m(kv, bb.hidden_size), "bias": m(kv)},
             "o_proj": {"weight": m(bb.hidden_size, q)},
             "gate_proj": {"weight": m(bb.intermediate_size, bb.hidden_size)},
             "up_proj": {"weight": m(bb.intermediate_size, bb.hidden_size)},
             "down_proj": {"weight": m(bb.hidden_size, bb.intermediate_size)},
             "input_layernorm": {"weight": m(bb.hidden_size)}}
    return {"backbone": {"layers": [layer], "embed_tokens": {"weight": m(10, bb.hidden_size)}},
            "llm_decoder": {"weight": m(cfg.full_vocab, bb.hidden_size),
                            "bias": m(cfg.full_vocab)}}


@pytest.mark.parametrize("backbone,tp,attention", [
    ("qwen2", 2, True), ("qwen2", 4, False), ("qwen2", 7, False),
    ("qwen3", 2, True), ("qwen3", 4, True), ("qwen3", 8, True), ("qwen3", 16, False)])
def test_head_aligned_attention(backbone, tp, attention):
    """Qwen2-0.5B (14 heads, 2 kv heads) splits attention at tp 2 only;
    Qwen3-0.6B (16, 8) at 2, 4 and 8.  Where attention stays whole, the
    MLP and the speech head still split where tp divides them."""
    cfg = port_config.TTSConfig().llm
    if backbone == "qwen3":
        cfg = port_config.LMConfig(backbone=port_config.qwen3_0_6b_config())
    bb = cfg.backbone
    specs = port_tp.lm_tp_specs(_layer_shapes(cfg), tp, bb.num_heads, bb.num_kv_heads)
    layer = specs["backbone"]["layers"][0]
    assert port_tp.heads_split(tp, bb.num_heads, bb.num_kv_heads) == attention
    for name in ("q_proj", "k_proj", "v_proj"):
        assert layer[name]["weight"] == (("tp", None) if attention else ()), name
    assert layer["o_proj"]["weight"] == ((None, "tp") if attention else ())
    mlp = bb.intermediate_size % tp == 0
    assert layer["gate_proj"]["weight"] == (("tp", None) if mlp else ())
    assert layer["down_proj"]["weight"] == ((None, "tp") if mlp else ())
    assert specs["llm_decoder"]["weight"] == (("tp", None) if cfg.full_vocab % tp == 0 else ())


def test_qwen2_at_tp2_holds_whole_head_groups():
    """At tp 2, process r of Qwen2-0.5B holds query heads 7r..7r+6 and kv
    head r: rows [448r, 448r + 448) of q_proj and [64r, 64r + 64) of k_proj."""
    cfg = port_config.TTSConfig().llm
    tree = _layer_shapes(cfg)
    for r in range(2):
        local = port_tp.shard_lm_tp(tree, port_tp.TPMesh(2, r, None), cfg)
        layer = local["backbone"]["layers"][0]
        assert layer["q_proj"]["weight"].shape == (448, 896)
        assert layer["k_proj"]["weight"].shape == (64, 896)
        assert layer["o_proj"]["weight"].shape == (896, 448)
        assert layer["down_proj"]["weight"].shape == (896, 2432)
        assert local["llm_decoder"]["weight"].shape == (3282, 896)


def test_tree_maps_keep_the_slices_group_and_a_lost_mark_raises():
    """``tree_map`` (``cast_floating``, a copy) rebuilds a ``Sliced`` module
    with its mesh; a tree whose slices lost the mark raises at the first
    row-parallel product instead of summing nothing."""
    cfg = PCFG.llm
    mesh = port_tp.TPMesh(2, 0, None)
    local = port_tp.shard_lm_tp(port_llm.init_lm(torch.Generator().manual_seed(0), cfg), mesh,
                                cfg)
    cast = tree_map(lambda t: t.clone(), cast_floating(local, torch.float64))
    for tree in (local, cast):
        assert isinstance(tree["llm_decoder"], port_tp.Sliced)
        assert tree["backbone"]["layers"][0]["o_proj"].mesh is mesh
    assert cast["llm_decoder"]["weight"].dtype == torch.float64

    def unmark(node):
        if isinstance(node, dict):
            return {k: unmark(v) for k, v in node.items()}
        if isinstance(node, list):
            return [unmark(v) for v in node]
        return node

    ids, src, plen, _, _, max_gen = _prompt()
    with pytest.raises(ValueError, match="lost its tp.Sliced marks"):
        port_llm.lm_prefill(unmark(local), cfg, *[torch.tensor(a).long() for a in (ids, src, plen)],
                            max_gen)
    hidden = torch.zeros(1, cfg.backbone.hidden_size)
    with pytest.raises(ValueError, match="lost its tp.Sliced marks"):
        port_llm.head_logits(unmark(local), cfg, hidden)


def test_a_tp_that_divides_nothing_raises():
    cfg = port_config.TTSConfig().llm
    with pytest.raises(ValueError, match="divides no tensor"):
        port_tp.shard_lm_tp(_layer_shapes(cfg), port_tp.TPMesh(5, 0, None), cfg)
    with pytest.raises(ValueError, match="world size 1"):
        port_tp.make_tp_mesh(2)


def _prompt(seed=1, p_bucket=64):
    rng = np.random.default_rng(seed)
    n_text, n_sp = 12, 8
    ids = np.zeros((2, p_bucket), np.int32)
    src = np.zeros((2, p_bucket), np.int32)
    ids[:, 1:1 + n_text] = rng.integers(2, JCFG.llm.backbone.vocab_size, (2, n_text))
    src[:, 1:1 + n_text] = jax_llm.SRC_TEXT
    ids[:, 1 + n_text] = JCFG.llm.task_id
    ids[:, 2 + n_text:2 + n_text + n_sp] = rng.integers(0, JCFG.llm.speech_token_size, (2, n_sp))
    src[:, 2 + n_text:2 + n_text + n_sp] = jax_llm.SRC_SPEECH
    prompt_len = np.array([2 + n_text + n_sp, 2 + n_text + 3], np.int32)
    return ids, src, prompt_len, np.array([5, 20]), np.array([40, 60]), 64


@pytest.fixture(scope="module")
def tp_group(tmp_path_factory):
    """JAX's decode on ``shard_lm_tp(params, make_tp_mesh(2))`` (fp32, and
    int8 through its ``weight_q_xla`` route) and its sharded prefill; the
    port's on 2 processes, each with its slices, under the same draws."""
    jp = jax_llm.init_lm(jax.random.key(0), JCFG.llm)
    prompt = _prompt()
    ids, src, plen, min_len, max_len, max_gen = prompt
    key = jax.random.key(11)
    fn = jax.jit(jax_llm.lm_decode, static_argnums=(1, 8))
    mesh = jax_tp.make_tp_mesh(2)
    want = {}
    for name, tree in (("fp32", jp), ("int8", jax_quantize(jp))):
        sharded = jax_tp.shard_lm_tp(tree, mesh)
        toks, lens = fn(sharded, JCFG.llm, *map(jnp.asarray, (ids, src, plen, min_len, max_len)),
                        key, max_gen)
        st = jax_llm.lm_prefill(sharded, JCFG.llm, jnp.asarray(ids), jnp.asarray(src),
                                jnp.asarray(plen), jax.random.key(0), max_gen)
        want[name] = (np.asarray(toks), np.asarray(lens), np.asarray(st.last_hidden),
                      to_numpy(sharded))
    d = lm_draws_from_key(key, 2, max_gen, JCFG.llm.top_k, JCFG.llm.full_vocab)
    steps = [d(i) for i in range(max_gen)]
    draws = (np.stack([a.numpy() for a, _ in steps]), np.stack([b.numpy() for _, b in steps]))
    ranks = W.run_group(W.tp_decode, 2, tmp_path_factory.mktemp("tp"), lm_cfg=PCFG.llm,
                        params=to_numpy(jp), prompt=prompt, draws=draws)
    return ranks, want, draws, prompt


@pytest.mark.parametrize("name", ["fp32", "int8", "recast"])
def test_tp2_decode_tokens_equal_jax(tp_group, name):
    """tp=2 decode tokens equal JAX's sharded decode's; "recast": the fp32
    slices after ``cast_floating`` and a ``tree_map`` copy."""
    ranks, want, _, _ = tp_group
    toks_j, lens_j = want["int8" if name == "int8" else "fp32"][:2]
    for r in ranks:
        toks, lens = r[f"{name}_tokens"]
        np.testing.assert_array_equal(lens, lens_j)
        for b in range(2):
            np.testing.assert_array_equal(toks[b, :lens_j[b]], toks_j[b, :lens_j[b]])
    assert lens_j.min() > 0


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_tp2_prefill_and_slices(tp_group, name):
    """The prefill's last hidden state on every process within 1e-5 of
    JAX's sharded prefill; each process holds half of q/k/v/o, gate/up/down
    and the head (the tiny config: 4 heads, 2 kv heads of 16) and a KV
    cache of one kv head."""
    ranks, want, _, _ = tp_group
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}_hidden"], want[name][2], rtol=1e-5, atol=1e-5)
        assert r[f"{name}_shapes"] == {"q_proj": (32, 64), "k_proj": (16, 64), "v_proj": (16, 64),
                                       "o_proj": (64, 32), "gate_proj": (64, 64),
                                       "up_proj": (64, 64), "down_proj": (64, 64)}
        assert r[f"{name}_head"] == (PCFG.llm.full_vocab // 2, 64)
        assert r[f"{name}_kv_heads"] == 1


def test_dense_on_a_tree_jax_sharded(tp_group):
    """JAX's tensor-parallel int8 tree (``weight_q_xla`` keys) in one
    process: ``dense`` takes JAX's XLA route, and the decode gives JAX's
    tokens."""
    _, want, draws, prompt = tp_group
    toks_j, lens_j, _, sharded = want["int8"]
    assert "weight_q_xla" in sharded["backbone"]["layers"][0]["q_proj"]
    ids, src, plen, min_len, max_len, max_gen = prompt
    toks, lens, _ = port_llm.lm_decode(
        tree_map(torch.tensor, sharded), PCFG.llm,
        *[torch.tensor(a).long() for a in (ids, src, plen, min_len, max_len)], max_gen,
        draws=W._draws(*draws))
    np.testing.assert_array_equal(lens.numpy(), lens_j)
    for b in range(2):
        np.testing.assert_array_equal(toks[b, :lens_j[b]].numpy(), toks_j[b, :lens_j[b]])


def test_ttsmodel_tp2_tts_equals_tp0(tmp_path):
    """``load(tp=2)`` on 2 processes, every process making the same call with
    the same seed: the same tokens and audio within 1e-5 of ``tp=0``; an
    ``EngineAPI`` over the model then serves from process 0, which the other
    follows until it closes."""
    rng = np.random.default_rng(0)
    prompt = {"prompt_feat": rng.standard_normal((12, PCFG.flow.output_size)).astype(np.float32),
              "speech_tokens": rng.integers(0, PCFG.llm.speech_token_size, 6).astype(np.int32),
              "embedding": rng.standard_normal(192).astype(np.float32)}
    text = "Bonjour tout le monde."
    model = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    want, sr = model.tts(text, prompt)
    ranks = W.run_group(W.tp_tts, 2, tmp_path, config=PCFG, prompt=prompt, text=text)
    for r in ranks:
        assert r["sr"] == sr and r["tokens"] == model._model.last_n_tokens > 0
        assert r["wav"].shape == want.shape
        np.testing.assert_allclose(r["wav"], want, atol=1e-5)
        assert r["q_rows"] == (32, 64)
    assert [r["role"] for r in ranks] == ["server", "follower"]


@pytest.fixture(scope="module")
def tp_entries(tmp_path_factory):
    return W.run_group(W.tp_entries, 2, tmp_path_factory.mktemp("entries"), config=PCFG)


@pytest.mark.parametrize("entry", ["engine", "http", "grpc", "webui"])
def test_serving_entries_under_tp(tp_entries, entry):
    """The engine and each server's entry (the HTTP routes, the gRPC
    servicer, the web UI) build under tp=2 on both processes without
    raising: process 0 serves (its engine's loop starts at once and stops
    on ``close``), process 1 follows until process 0 closes."""
    if entry == "grpc":
        pytest.importorskip("grpc")
    (role0, alive), (role1, steps) = tp_entries[0][entry], tp_entries[1][entry]
    assert (role0, role1) == ("server", "follower")
    assert alive is False and steps == 0


def test_a_tensor_parallel_model_serves_only_through_the_engine():
    """A tp model handed to a server without ``EngineAPI`` raises
    ``ValueError`` before anything binds: only the engine keeps the group
    in step."""
    import types

    from cosyvoice2_eu_torch.serving import engine, grpc_server, http_server

    api = types.SimpleNamespace(_model=types.SimpleNamespace(tp=2, cfg=PCFG))
    for make in (http_server._routes, grpc_server.CosyVoiceServicer):
        with pytest.raises(ValueError, match="served through EngineAPI"):
            make(api)
    engine.check_servable(types.SimpleNamespace(_model=types.SimpleNamespace(tp=0)))
