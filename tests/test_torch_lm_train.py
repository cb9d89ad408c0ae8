"""The speech LM's training in the port against the JAX package (tiny
config, fp32, CPU): ``label_smoothing_ce``, ``dpo_loss``, the unistream and
bistream sequence builders, ``lm_loss_fn`` and ``make_lm_train_step``, LoRA
(``apply_lora``, ``merge_lora``, its step) and DPO (``dpo_loss_fn``, its
step), and the trainer's LM step functions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import assert_trees_close, t, to_numpy, to_port

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.parallel import train_step as port_ts
from cosyvoice2_eu_torch.train import dpo as port_dpo
from cosyvoice2_eu_torch.train import lora as port_lora
from cosyvoice2_eu_torch.train import losses as port_losses
from cosyvoice2_eu_torch.train import optim as port_optim
from cosyvoice2_eu_torch.train import sequences as port_seq
from cosyvoice2_eu_torch.train.train import make_lm_step_fn
from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.models import llm as jax_llm
from cosyvoice2_eu_tpu.parallel import train_step as jax_ts
from cosyvoice2_eu_tpu.train import dpo as jax_dpo
from cosyvoice2_eu_tpu.train import lora as jax_lora
from cosyvoice2_eu_tpu.train import losses as jax_losses
from cosyvoice2_eu_tpu.train import optim as jax_optim
from cosyvoice2_eu_tpu.train import sequences as jax_seq

LM = jax_config.tiny_test_config().llm
PLM = port_config.tiny_test_config().llm
# the flow step's gates (tests/test_torch_train.py): loss 1e-5 relative, each
# gradient leaf within 1e-4 of its largest JAX entry + 1e-7
LOSS_RTOL, GRAD_REL, GRAD_ABS = 1e-5, 1e-4, 1e-7
KW = dict(lr=1e-3, accum_grad=1)
J_TC, P_TC = jax_config.TrainConfig(**KW), port_config.TrainConfig(**KW)
# parameters after an Adam step: its first update is lr x g / (|g| + 1e-8),
# which a gradient near 1e-8 can move by a good part of lr (a leaf's largest
# move is lr), so they are held to 5% of lr
PARAM_ATOL = 0.05 * KW["lr"]


@pytest.fixture(scope="module")
def params():
    p = jax_llm.init_lm(jax.random.key(0), LM)
    return p, to_port(p)


def _rows(seed, n=3):
    """Texts of 6-12 tokens and speech of 3.2-6x as many (so each row may
    take the bistream layout)."""
    rng = np.random.default_rng(seed)
    texts = [rng.integers(2, LM.backbone.vocab_size, rng.integers(6, 13)).astype(np.int32)
             for _ in range(n)]
    speeches = [rng.integers(0, LM.speech_token_size, int(len(x) * rng.uniform(3.2, 6)))
                .astype(np.int32) for x in texts]
    return texts, speeches


def _batch(seed, pad_to=None):
    texts, speeches = _rows(seed)
    return jax_seq.build_lm_batch(texts, speeches, LM, np.random.default_rng(seed), 0.5, pad_to)


def _port_batch(b):
    return {k: t(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("normalize_length", [True, False])
def test_label_smoothing_ce_matches_jax(smoothing, normalize_length):
    """Loss and accuracy on (3, 7, 20) logits with ignored positions and a
    row with none supervised: 1e-6."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 20)).astype(np.float32) * 3
    target = rng.integers(0, 20, (3, 7)).astype(np.int32)
    target[0, :3] = target[2] = -1
    target[1, 5] = np.argmax(logits[1, 5])  # one right guess at least
    want = jax_losses.label_smoothing_ce(jnp.asarray(logits), jnp.asarray(target), smoothing,
                                         normalize_length)
    got = port_losses.label_smoothing_ce(t(logits), t(target), smoothing, normalize_length)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-7)
    assert port_losses.IGNORE_ID == jax_losses.IGNORE_ID == port_seq.IGNORE_ID


def test_dpo_loss_matches_jax():
    rng = np.random.default_rng(2)
    logps = [rng.standard_normal(4).astype(np.float32) * 5 for _ in range(4)]
    for ls in (0.0, 0.2):
        want = jax_losses.dpo_loss(*map(jnp.asarray, logps), beta=0.1, label_smoothing=ls)
        got = port_losses.dpo_loss(*map(t, logps), beta=0.1, label_smoothing=ls)
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-6)


@pytest.mark.parametrize("n_text", [0, 4, 5, 10, 12])
def test_sequence_builders_match_jax(n_text):
    """Unistream and bistream layouts, exactly: text lengths below, at and
    past multiples of ``mix_ratio[0]``."""
    rng = np.random.default_rng(n_text)
    text = rng.integers(2, 200, n_text).astype(np.int32)
    speech = rng.integers(0, 81, 3 * n_text + 20).astype(np.int32)
    for name in ("build_unistream", "build_bistream"):
        for g, w in zip(getattr(port_seq, name)(text, speech, PLM),
                        getattr(jax_seq, name)(text, speech, LM)):
            assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_lm_batch_matches_jax(seed):
    """The batch and the rng's state after it: the same coin tosses, drawn
    only for rows that may take the bistream layout (one row here may not)."""
    texts, speeches = _rows(seed)
    speeches[1] = speeches[1][:len(texts[1]) * 2]
    r_p, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = port_seq.build_lm_batch(texts, speeches, PLM, r_p, 0.5, pad_to=200)
    want = jax_seq.build_lm_batch(texts, speeches, LM, r_j, 0.5, pad_to=200)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert r_p.random() == r_j.random()


def test_sequence_builders_raise_value_errors():
    """Where the JAX package asserts (``python -O`` drops it), the port raises."""
    text = np.arange(10, dtype=np.int32)
    with pytest.raises(ValueError, match="bistream needs 15 speech tokens"):
        port_seq.build_bistream(text, np.arange(20, dtype=np.int32), PLM)
    with pytest.raises(AssertionError):
        jax_seq.build_bistream(text, np.arange(20, dtype=np.int32), LM)
    with pytest.raises(ValueError, match="pad_to=5"):
        port_seq.build_lm_batch([text], [np.arange(60, dtype=np.int32)], PLM,
                                np.random.default_rng(0), pad_to=5)


@pytest.fixture(scope="module")
def jax_lm_value_and_grad():
    return jax.jit(jax.value_and_grad(lambda p, b: jax_ts.lm_loss_fn(p, LM, b, J_TC),
                                      has_aux=True))


def test_lm_loss_fn_value_and_grads_match_jax(params, jax_lm_value_and_grad):
    """A batch holding both layouts: loss, accuracy and every gradient leaf."""
    jp, pp = params
    batch = _batch(3)
    assert _layouts(batch) == {"unistream", "bistream"}
    (want, wm), want_g = jax_lm_value_and_grad(jp, _jax_batch(batch))
    (got, gm), got_g = port_ts.value_and_grad(
        lambda p: port_ts.lm_loss_fn(p, PLM, _port_batch(batch), P_TC), pp)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gm["acc"]), float(wm["acc"]), atol=1e-7)
    assert_trees_close(got_g, to_numpy(want_g), GRAD_REL, GRAD_ABS)


def _layouts(batch) -> set:
    fill = LM.speech_token_size + 2
    return {"bistream" if (row == fill).any() else "unistream" for row in batch["target"]}


def test_lm_train_step_matches_jax(params):
    """One ``make_lm_train_step`` step (adamw, lr 1e-3) against JAX's jitted
    step on a batch of both layouts: loss, grad norm, Adam's first moment
    (0.1 x the clipped gradient) and the parameters after the update."""
    jp, pp = params
    batch = _batch(6)
    assert _layouts(batch) == {"unistream", "bistream"}
    j_tx, p_tx = jax_optim.make_optimizer(J_TC), port_optim.make_optimizer(P_TC)
    j_state, j_m = jax_ts.make_lm_train_step(LM, J_TC, j_tx)(
        jax_ts.init_train_state(jax.tree.map(jnp.copy, jp), j_tx), _jax_batch(batch))
    p_state, p_m = port_ts.make_lm_train_step(PLM, P_TC, p_tx)(
        port_ts.init_train_state(pp, p_tx), _port_batch(batch))
    np.testing.assert_allclose(float(p_m["loss"]), float(j_m["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(p_m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-5)
    assert p_state.step == int(j_state.step) == 1
    assert_trees_close(p_state.opt_state["mu"],
                       to_numpy(optax.tree_utils.tree_get(j_state.opt_state, "mu")),
                       GRAD_REL, GRAD_ABS)
    assert_trees_close(p_state.params, to_numpy(j_state.params), 0.0, PARAM_ATOL)


def test_lora_matches_jax(params):
    """JAX's adapters carried across: ``apply_lora`` and ``merge_lora``
    equal, then two adapter steps (the first moves only B, as B = 0 zeroes
    A's gradient; the second moves both): loss, every adapter gradient and
    the adapters after each step; the base never moves."""
    jp, pp = params
    j_lora = jax_lora.init_lora(jax.random.key(7), jp, rank=4)
    p_lora = tree_map(t, to_numpy(j_lora))
    assert_trees_close(port_lora.merge_lora(pp, p_lora, 8.0),
                       to_numpy(jax_lora.merge_lora(jp, j_lora, 8.0)), 0.0, 1e-6)
    base = tree_map(torch.clone, pp)
    j_tx, p_tx = jax_optim.make_optimizer(J_TC), port_optim.make_optimizer(P_TC)
    j_step = jax_lora.make_lora_lm_train_step(LM, J_TC, j_tx, jp, alpha=8.0)
    p_step = port_lora.make_lora_lm_train_step(PLM, P_TC, p_tx, pp, alpha=8.0)
    j_grad = jax.jit(jax.value_and_grad(lambda lo, b: jax_ts.lm_loss_fn(
        jax_lora.apply_lora(jp, lo, 8.0), LM, b, J_TC), has_aux=True))
    j_state, p_state = jax_ts.init_train_state(j_lora, j_tx), port_ts.init_train_state(p_lora, p_tx)
    for seed in (5, 6):
        batch = _batch(seed)
        (want, _), want_g = j_grad(j_state.params, _jax_batch(batch))
        (got, _), got_g = port_ts.value_and_grad(lambda lo: port_ts.lm_loss_fn(
            port_lora.apply_lora(pp, lo, 8.0), PLM, _port_batch(batch), P_TC), p_state.params)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        assert_trees_close(got_g, to_numpy(want_g), GRAD_REL, GRAD_ABS)
        j_state, j_m = j_step(j_state, _jax_batch(batch))
        p_state, p_m = p_step(p_state, _port_batch(batch))
        np.testing.assert_allclose(float(p_m["loss"]), float(j_m["loss"]), rtol=LOSS_RTOL)
        assert_trees_close(p_state.params, to_numpy(j_state.params), 0.0, PARAM_ATOL)
    assert float(p_m["grad_norm"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*map(tree_leaves, (pp, base))))


def test_init_lora_draws_from_its_generator(params):
    _, pp = params
    a = port_lora.init_lora(torch.Generator().manual_seed(1), pp, rank=4)
    b = port_lora.init_lora(torch.Generator().manual_seed(1), pp, rank=4)
    first = a["layers"][0]
    assert set(first) == set(port_lora.DEFAULT_TARGETS) and len(a["layers"]) == 2
    assert first["q_proj"]["A"].shape == (4, 64) and first["q_proj"]["B"].shape == (64, 4)
    assert not first["q_proj"]["B"].any() and 0.005 < float(first["q_proj"]["A"].std()) < 0.02
    assert all(torch.equal(x, y) for x, y in zip(*map(tree_leaves, (a, b))))


def _dpo_batch(seed):
    chosen = _batch(seed, pad_to=100)
    texts, speeches = _rows(seed)
    rng = np.random.default_rng(seed + 50)
    rejected = jax_seq.build_lm_batch(
        texts, [rng.integers(0, LM.speech_token_size, len(s)).astype(np.int32) for s in speeches],
        LM, np.random.default_rng(seed), 0.5, 100)
    return dict(chosen, **{f"reject_{k}": v for k, v in rejected.items()})


def test_dpo_matches_jax(params):
    """``dpo_loss_fn`` against a reference policy one perturbation away:
    every metric and every gradient leaf; then one DPO step (loss,
    parameters after it), which leaves the reference parameters as given."""
    jp, pp = params
    ref_j = jax.tree.map(lambda a: a * 1.01, jp)
    ref_p = to_port(ref_j)
    batch = _dpo_batch(8)
    (want, wm), want_g = jax.jit(jax.value_and_grad(
        lambda p, r, b: jax_dpo.dpo_loss_fn(p, r, LM, b, 0.1), has_aux=True))(
        jp, ref_j, _jax_batch(batch))
    (got, gm), got_g = port_ts.value_and_grad(
        lambda p: port_dpo.dpo_loss_fn(p, ref_p, PLM, _port_batch(batch), 0.1), pp)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert_trees_close(got_g, to_numpy(want_g), GRAD_REL, GRAD_ABS)

    j_tx, p_tx = jax_optim.make_optimizer(J_TC), port_optim.make_optimizer(P_TC)
    j_state, j_m = jax_dpo.make_dpo_train_step(LM, J_TC, j_tx, ref_j, beta=0.1)(
        jax_ts.init_train_state(jax.tree.map(jnp.copy, jp), j_tx), _jax_batch(batch))
    ref_before = tree_map(torch.clone, ref_p)
    p_state, p_m = port_dpo.make_dpo_train_step(PLM, P_TC, p_tx, ref_p, beta=0.1)(
        port_ts.init_train_state(pp, p_tx), _port_batch(batch))
    np.testing.assert_allclose(float(p_m["loss"]), float(j_m["loss"]), rtol=LOSS_RTOL)
    assert_trees_close(p_state.params, to_numpy(j_state.params), 0.0, PARAM_ATOL)
    assert all(torch.equal(a, b) for a, b in zip(*map(tree_leaves,
                                                      (ref_p, ref_before))))


@pytest.mark.parametrize("mode", ["lm", "lora", "dpo"])
def test_trainer_lm_step_fns(params, mode):
    """The trainer's LM branch: each mode's step moves what it trains and its
    CV function gives the loss metrics of the trained parameters."""
    _, pp = params
    tx = port_optim.make_optimizer(P_TC)
    trained, step_fn, cv_fn = make_lm_step_fn(
        PLM, P_TC, tx, pp, dpo=mode == "dpo", lora=mode == "lora", lora_rank=4,
        gen=torch.Generator().manual_seed(2))
    batch = _port_batch(_dpo_batch(9) if mode == "dpo" else _batch(9))
    state, m = step_fn(port_ts.init_train_state(trained, tx), batch)
    assert state.step == 1 and np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    cv = cv_fn(state.params, batch)
    assert np.isfinite(float(cv["loss"])) and ("dpo" in cv) == (mode == "dpo")
    if mode == "lora":
        assert set(state.params) == {"layers"}
    moved = [not torch.equal(a, b) for a, b in zip(*map(tree_leaves,
                                                        (state.params, trained)))]
    assert any(moved)
