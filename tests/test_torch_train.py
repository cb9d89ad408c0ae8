"""Parity of the port's flow training with the JAX package (tiny config,
fp32, CPU): TrainConfig, cfm_loss, flow_loss_fn's loss and gradients, the
optimizer chain against optax, the schedules, one train step, and the
executor's checkpoint/resume; the card's train step against the CPU plain
path (``cuda``-marked)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import (  # noqa: F401 (fixture)
    assert_trees_close,
    cuda_device,
    flow_draws_from_key,
    t,
    to_numpy,
    to_port,
)

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.parallel import train_step as port_ts
from cosyvoice2_eu_torch.train import executor as port_exec
from cosyvoice2_eu_torch.train import losses as port_losses
from cosyvoice2_eu_torch.train import optim as port_optim
from cosyvoice2_eu_torch.train.train import make_flow_cv_fn, make_flow_step_fn
from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.models.flow import init_flow
from cosyvoice2_eu_tpu.parallel import train_step as jax_ts
from cosyvoice2_eu_tpu.train import losses as jax_losses
from cosyvoice2_eu_tpu.train import optim as jax_optim

CFG = jax_config.tiny_test_config().flow
PCFG = port_config.tiny_test_config().flow
# the loss within 1e-5 relative; each gradient leaf within 1e-4 of its
# largest JAX entry (+1e-7 for leaves that are nearly zero): fp32 through
# the encoder and the estimator, sums in another order
LOSS_RTOL, GRAD_REL, GRAD_ABS = 1e-5, 1e-4, 1e-7


@pytest.fixture(scope="module")
def params():
    p = init_flow(jax.random.key(0), CFG)
    return p, to_port(p)


def _batch(seed: int, token_lens=(30, 22)) -> dict:
    """A flow batch in the dataset's dict form (numpy, int32 lengths)."""
    rng = np.random.default_rng(seed)
    b, t_tok = len(token_lens), max(token_lens)
    tl = np.asarray(token_lens, np.int32)
    return {
        "speech_token": rng.integers(0, CFG.vocab_size, (b, t_tok)).astype(np.int32),
        "speech_token_len": tl,
        "speech_feat": rng.standard_normal((b, 2 * t_tok, CFG.output_size)).astype(np.float32),
        "speech_feat_len": 2 * tl,
        "embedding": rng.standard_normal((b, CFG.spk_embed_dim)).astype(np.float32),
    }


def _port_batch(batch, device="cpu"):
    return {k: t(v).to(device) for k, v in batch.items()}


def test_train_config_matches_jax():
    assert port_config.config_to_dict(port_config.TrainConfig()) == \
        jax_config.config_to_dict(jax_config.TrainConfig())


@pytest.mark.parametrize("t_scheduler,cfg_rate", [("cosine", 0.2), ("linear", 0.0)])
def test_cfm_loss_matches_jax(t_scheduler, cfg_rate):
    """cfm_loss with a linear stand-in estimator and JAX's draws rebuilt from
    the key (cfm_loss splits it into k_t, k_z, k_cfg).  fp32: rtol 1e-5."""
    rng = np.random.default_rng(1)
    b, c, n = 3, 16, 40
    x1, mu, cond = (rng.standard_normal((b, c, n)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((b, c)).astype(np.float32)
    mask = (np.arange(n)[None, None] < np.array([40, 31, 9])[:, None, None]).astype(np.float32)
    w = rng.standard_normal((c, 4 * c)).astype(np.float32) * 0.1

    def jax_est(y, m, mu_, tt, s, cd):
        h = jnp.concatenate([y, mu_, jnp.broadcast_to(s[:, :, None], y.shape), cd], 1)
        return (jnp.asarray(w) @ h) * (1.0 + tt[:, None, None]) * m

    def port_est(y, m, mu_, tt, s, cd):
        h = torch.cat([y, mu_, s[:, :, None].expand(*y.shape), cd], 1)
        return (t(w) @ h) * (1.0 + tt[:, None, None]) * m

    key = jax.random.key(4)
    want = jax_losses.cfm_loss(jax_est, *map(jnp.asarray, (x1, mask, mu, spks, cond)), key,
                               training_cfg_rate=cfg_rate, t_scheduler=t_scheduler)
    k_t, k_z, k_cfg = jax.random.split(key, 3)
    got = port_losses.cfm_loss(
        port_est, *map(t, (x1, mask, mu, spks, cond)),
        t(jax.random.uniform(k_t, (b, 1, 1), jnp.float32)),
        t(jax.random.normal(k_z, (b, c, n), jnp.float32)), t(jax.random.uniform(k_cfg, (b,))),
        training_cfg_rate=cfg_rate, t_scheduler=t_scheduler)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(
        lambda p, b, key, streaming: jax_ts.flow_loss_fn(p, CFG, b, key, streaming),
        has_aux=True), static_argnums=3)


@pytest.mark.parametrize("streaming", [False, True])
def test_flow_loss_fn_value_and_grads_match_jax(params, jax_value_and_grad, streaming):
    """flow_loss_fn's loss and every gradient leaf (rand_noise's zeros
    included) against jax.value_and_grad, with JAX's draws rebuilt from the
    key chain; ragged token lengths, streaming or not."""
    jp, pp = params
    batch = _batch(5)
    key = jax.random.key(6)
    (want, _), want_g = jax_value_and_grad(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                           key, streaming)
    b, t_mel = batch["speech_feat"].shape[:2]
    draws = flow_draws_from_key(key, b, CFG.output_size, t_mel)
    (got, metrics), got_g = port_ts.value_and_grad(
        lambda p: port_ts.flow_loss_fn(p, PCFG, _port_batch(batch), draws, streaming), pp)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert float(metrics["loss"]) == float(got)
    assert not got_g["rand_noise"].any()
    assert_trees_close(got_g, to_numpy(want_g), GRAD_REL, GRAD_ABS)


def test_flow_train_step_matches_jax(params):
    """One make_flow_train_step step (adamw, lr 1e-3, no accumulation)
    against JAX's jitted step: loss, grad norm, step count, and every
    gradient leaf as Adam's first moment holds it (mu = 0.1 clip(g))."""
    jp, pp = params
    kw = dict(lr=1e-3, accum_grad=1)
    j_tc, p_tc = jax_config.TrainConfig(**kw), port_config.TrainConfig(**kw)
    j_tx, p_tx = jax_optim.make_optimizer(j_tc), port_optim.make_optimizer(p_tc)
    batch = _batch(7, (30, 17))
    key = jax.random.key(8)
    j_state, j_m = jax_ts.make_flow_train_step(CFG, j_tc, j_tx)(
        jax_ts.init_train_state(jax.tree.map(jnp.copy, jp), j_tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, streaming=True)
    b, t_mel = batch["speech_feat"].shape[:2]
    draws = flow_draws_from_key(key, b, CFG.output_size, t_mel)
    p_state, p_m = port_ts.make_flow_train_step(PCFG, p_tc, p_tx)(
        port_ts.init_train_state(pp, p_tx), _port_batch(batch), draws, streaming=True)
    np.testing.assert_allclose(float(p_m["loss"]), float(j_m["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(p_m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-5)
    assert p_state.step == int(j_state.step) == 1 and p_state.opt_state["count"] == 1
    assert_trees_close(p_state.opt_state["mu"],
                       to_numpy(optax.tree_utils.tree_get(j_state.opt_state, "mu")),
                       GRAD_REL, GRAD_ABS)


def _opt_params(rng):
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal(4).astype(np.float32)},
                       {"b": rng.standard_normal(4).astype(np.float32)}],
            "zero_grad": rng.standard_normal(2).astype(np.float32)}


@pytest.mark.parametrize("optim", ["adam", "adamw"])
@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(optim, accum):
    """make_optimizer against the JAX package's optax chain over 6 steps:
    warmup schedule, clipping active (grad norms ~5-10 against 2), a leaf
    with zero gradients, and an inf gradient at step 3 (skipped; with
    accumulation it poisons the running mean, as in optax).  Parameters and
    Adam moments after every step within 1e-6."""
    kw = dict(optim=optim, lr=1e-2, weight_decay=0.01 if optim == "adamw" else 0.0,
              scheduler="warmuplr", warmup_steps=3, grad_clip=2.0, accum_grad=accum)
    j_tx = jax_optim.make_optimizer(jax_config.TrainConfig(**kw))
    p_tx = port_optim.make_optimizer(port_config.TrainConfig(**kw))
    rng = np.random.default_rng(3)
    jp = jax.tree.map(jnp.asarray, _opt_params(rng))
    pp = tree_map(t, to_numpy(jp))
    j_state, p_state = j_tx.init(jp), p_tx.init(pp)
    for step in range(6):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 3, jp)
        g["zero_grad"] = np.zeros(2, np.float32)
        if step == 3:
            g["w"][1, 1] = np.inf
        updates, j_state = j_tx.update(jax.tree.map(jnp.asarray, g), j_state, jp)
        jp = optax.apply_updates(jp, updates)
        pp, p_state = p_tx.step(pp, tree_map(t, g), p_state)
        assert_trees_close(pp, to_numpy(jp), 0.0, 1e-6)
        for moment in ("mu", "nu"):
            assert_trees_close(p_state[moment], to_numpy(optax.tree_utils.tree_get(j_state, moment)),
                               0.0, 1e-6)
    assert p_state["total_notfinite"] == (1 if accum == 1 else 2)


SCHEDULES = ["warmuplr", "constantlr", "noamhold", "noamannealing", "cosineannealing",
             "squareannealing", "squarerootannealing", "squarerootconstant"]


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("constant_steps", [0, 5])
def test_schedules_match_jax(name, constant_steps):
    """make_schedule against the JAX schedules at steps 0..40 (warmup 6,
    max 30, so warmup, decay and the tail are all visited).  float32 on
    both sides: rtol 1e-6."""
    kw = dict(lr=1e-3, scheduler=name, warmup_steps=6, max_steps=30, min_lr=1e-5,
              constant_steps=constant_steps)
    j_s = jax_optim.make_schedule(jax_config.TrainConfig(**kw))
    p_s = port_optim.make_schedule(port_config.TrainConfig(**kw))
    for step in range(41):
        np.testing.assert_allclose(float(p_s(step)), float(j_s(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, err_msg=f"{name} step {step}")


def _trainer(pp, tmp, tc):
    tx = port_optim.make_optimizer(tc)
    raw = port_ts.make_flow_train_step(PCFG, tc, tx)

    def step_fn(state, batch):
        # draws and the streaming coin keyed on the step, so a resumed run
        # sees the same ones as an uninterrupted run
        gen = torch.Generator().manual_seed(1000 + state.step)
        draws = port_ts.make_flow_draws(gen, batch, PCFG.output_size)
        return raw(state, batch, draws, streaming=state.step % 2 == 1)

    ex = port_exec.Executor(tc, step_fn, make_flow_cv_fn(PCFG), model_dir=str(tmp))
    return ex, port_ts.init_train_state(pp, tx)


def test_executor_resume_equals_uninterrupted(params, tmp_path):
    """3 steps -> checkpoint (mid-accumulation, warmup schedule) -> restore
    into a differently initialised state -> 3 more steps equals 6
    uninterrupted steps exactly, on the CPU."""
    _, pp = params
    tc = port_config.TrainConfig(lr=1e-3, scheduler="warmuplr", warmup_steps=4, accum_grad=2,
                                 save_per_step=3, log_interval=1)
    batches = [_port_batch(_batch(20 + i, (30, 30 - 3 * i))) for i in range(6)]
    cv = [_port_batch(_batch(40))]

    ex, state = _trainer(pp, tmp_path / "a", tc)
    logs = []
    ex.log_fn = logs.append
    full = ex.train_epoch(state, batches, cv)
    assert [m["step"] for m in logs] == list(range(1, 7))
    assert all(math.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in logs)
    infos = {i["tag"]: i for i in port_exec.list_checkpoints(str(tmp_path / "a"))}
    assert set(infos) == {"epoch_0_step_3", "epoch_0_step_6", "epoch_0_whole"}
    assert infos["epoch_0_step_3"]["has_opt"] and math.isfinite(infos["epoch_0_whole"]["cv_loss"])
    assert port_exec.latest_checkpoint(str(tmp_path / "a"))["step"] == 6

    other = tree_map(lambda x: x + 1.0, pp)  # proves the restore really loads
    ex_b, state_b = _trainer(other, tmp_path / "b", tc)
    state_b = port_exec.restore_train_state(str(tmp_path / "a"), infos["epoch_0_step_3"], state_b)
    assert state_b.step == 3 and state_b.opt_state["mini_step"] == 1
    ex_b.step = 3
    resumed = ex_b.train_epoch(state_b, batches[3:])
    assert resumed.step == full.step == 6
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.opt_state), tree_leaves(full.opt_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_average_checkpoints_takes_best_by_cv_loss(tmp_path):
    trees = [{"w": torch.full((2, 2), float(i)), "l": [torch.tensor([i * 2.0])]} for i in range(3)]
    for i, (tree, cv) in enumerate(zip(trees, (0.5, 0.1, 0.3))):
        port_exec.save_checkpoint(str(tmp_path), f"c{i}", tree, {"epoch": i, "step": i,
                                                                 "cv_loss": cv})
    avg, tags = port_exec.average_checkpoints(str(tmp_path), num=2)
    assert tags == ["c1", "c2"]
    assert torch.equal(avg["w"], torch.full((2, 2), 1.5)) and torch.equal(avg["l"][0],
                                                                           torch.tensor([3.0]))


def test_flow_step_fn_draws_and_coin(params):
    """The step wrapper draws from its generator and tosses the streaming coin
    from its numpy rng: two wrappers seeded alike give the same step."""
    _, pp = params
    seen = []

    def raw(state, batch, draws, streaming):
        seen.append((streaming, {k: v.clone() for k, v in draws.items()}))
        return state, {}

    batch = _port_batch(_batch(9))
    for _ in range(2):
        fn = make_flow_step_fn(raw, PCFG, torch.Generator().manual_seed(3),
                               np.random.default_rng(4))
        for _ in range(4):
            fn(None, batch)
    first, second = seen[:4], seen[4:]
    assert [s for s, _ in first] == [bool(x < 0.5) for x in np.random.default_rng(4).random(4)]
    for (s1, d1), (s2, d2) in zip(first, second):
        assert s1 == s2 and all(torch.equal(d1[k], d2[k]) for k in d1)
    assert not torch.equal(first[0][1]["z"], first[1][1]["z"])
    assert first[0][1]["z"].shape == (2, PCFG.output_size, 60)


@pytest.mark.cuda
def test_flow_train_step_on_card_matches_cpu(cuda_device):
    """One step on the card (K1 with LSE, K3, K4; fp32) against the CPU
    plain path with the same parameters and draws, on a small config with
    64-wide heads; skipped without a GPU.  Loss within 1e-5 relative, every
    gradient leaf (Adam's mu) as against JAX."""
    from cosyvoice2_eu_torch.models.flow import init_flow as port_init_flow
    from cosyvoice2_eu_torch.utils.device import resolve_device

    resolve_device(cuda_device)  # the training precision policy: no TF32
    cfg = dataclasses.replace(PCFG, estimator=dataclasses.replace(
        PCFG.estimator, attention_head_dim=64, num_heads=2))
    tc = port_config.TrainConfig(lr=1e-3, accum_grad=1)
    pp = port_init_flow(torch.Generator().manual_seed(1), cfg)
    batch = _port_batch(_batch(11, (90, 70)))
    draws = port_ts.make_flow_draws(torch.Generator().manual_seed(2), batch, cfg.output_size)
    out = {}
    for dev in ("cpu", cuda_device):
        tx = port_optim.make_optimizer(tc)
        step = port_ts.make_flow_train_step(cfg, tc, tx)
        state, m = step(port_ts.init_train_state(tree_map(lambda x: x.to(dev), pp), tx),
                        {k: v.to(dev) for k, v in batch.items()},
                        {k: v.to(dev) for k, v in draws.items()}, streaming=True)
        out[str(dev)] = (float(m["loss"]), state.opt_state["mu"])
    (l_cpu, mu_cpu), (l_gpu, mu_gpu) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=LOSS_RTOL)
    assert_trees_close(mu_gpu, tree_map(lambda x: x.numpy(), mu_cpu), GRAD_REL, GRAD_ABS)
