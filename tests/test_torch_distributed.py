"""The port's multi-process training (``parallel/distributed.py``,
``parallel/mesh.py``, the data-parallel step, the sharded optimizer state,
the trainers) against the JAX package's mesh on the CPU.

Each group is 2 processes on gloo (``tests/torch_dist_workers.py``); the
JAX side runs here, on ``conftest.py``'s 8 simulated devices.  Tolerances,
as in the one-process training tests: the loss within 1e-5 relative;
gradients, read from Adam's first moment (0.1 x the clipped gradient),
within 1e-4 of the leaf's largest entry + 1e-7; parameters after a first
Adam step, which moves an entry by lr x g / (|g| + 1e-8), within 5% of lr
where the first moment is clear of the gradient tolerance and within 2 lr
where it is not, since there the sign of g is not fixed
(``tests/test_torch_gan.py::_close_after_adam``).  The processes of a group
hold the same parameters bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dist_workers as W
from torch_parity import assert_trees_close, flow_draws_from_key, hift_draws_from_key, to_numpy

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.parallel import mesh as port_mesh
from cosyvoice2_eu_torch.parallel import train_step as port_ts
from cosyvoice2_eu_torch.train import executor as port_exec
from cosyvoice2_eu_torch.train import optim as port_optim
from cosyvoice2_eu_torch.train import train as port_train
from cosyvoice2_eu_torch.train import train_gan as port_train_gan
from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.models.flow import init_flow
from cosyvoice2_eu_tpu.models.llm import init_lm
from cosyvoice2_eu_tpu.parallel import mesh as jax_mesh
from cosyvoice2_eu_tpu.parallel import train_step as jax_ts
from cosyvoice2_eu_tpu.train import dpo as jax_dpo
from cosyvoice2_eu_tpu.train import optim as jax_optim
from cosyvoice2_eu_tpu.train import sequences as jax_seq
from cosyvoice2_eu_tpu.train import train as jax_train

JCFG, PCFG = jax_config.tiny_test_config(), port_config.tiny_test_config()
LOSS_RTOL, GRAD_REL, GRAD_ABS = 1e-5, 1e-4, 1e-7
KW = dict(lr=1e-3, accum_grad=1)
J_TC, P_TC = jax_config.TrainConfig(**KW), port_config.TrainConfig(**KW)
LR = KW["lr"]


def _mu(opt_state):
    return to_numpy(optax.tree_utils.tree_get(opt_state, "mu"))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got_np, want_np, rel, abs_):
    assert_trees_close(tree_map(torch.tensor, got_np), want_np, rel, abs_)


# ---------------------------------------------------------------------------
# the layout rules, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,fsdp", [((64, 16), 2), ((6, 4), 4), ((3, 5), 2), ((), 2),
                                        ((8,), 1), ((4, 12, 3), 4), ((2, 2), 4)])
def test_param_sharding_spec_matches_jax(shape, fsdp):
    want = jax_mesh.param_sharding_spec(jnp.zeros(shape), fsdp)
    got = port_mesh.param_sharding_spec(shape, fsdp)
    axis = next((i for i, a in enumerate(want) if a == "fsdp"), None)
    assert got == axis


@pytest.mark.parametrize("n,world", [(8, 2), (3, 2), (5, 4), (1, 2)])
def test_row_blocks_split_like_array_split(n, world):
    rows = np.arange(n)
    blocks = [rows[slice(*port_mesh.row_block(n, port_mesh.Mesh(world, 1, r, world)))]
              for r in range(world)]
    assert [b.tolist() for b in blocks] == [b.tolist() for b in np.array_split(rows, world)]


def test_shard_batch_pads_to_world_with_ignored_targets():
    batch = {"ids": np.arange(6).reshape(3, 2), "target": np.ones((3, 2), np.int32),
             "lengths": np.array([2, 1, 2])}
    parts = [port_mesh.shard_batch(batch, port_mesh.Mesh(2, 1, r, 2)) for r in range(2)]
    assert [p["ids"].shape[0] for p in parts] == [2, 2]
    assert parts[1]["lengths"].tolist() == [2, 0] and parts[1]["target"][1].tolist() == [-1, -1]


def test_make_mesh_in_one_process():
    m = port_mesh.make_mesh()
    assert (m.dp, m.fsdp, m.coords, m.fsdp_group) == (1, 1, (0, 0), None)
    with pytest.raises(ValueError, match="world size"):
        port_mesh.make_mesh(fsdp=2)


# ---------------------------------------------------------------------------
# data parallelism at world 2
# ---------------------------------------------------------------------------

def _flow_batch(seed, token_lens):
    rng = np.random.default_rng(seed)
    b, t_tok = len(token_lens), max(token_lens)
    tl = np.asarray(token_lens, np.int32)
    c = JCFG.flow
    return {"speech_token": rng.integers(0, c.vocab_size, (b, t_tok)).astype(np.int32),
            "speech_token_len": tl,
            "speech_feat": rng.standard_normal((b, 2 * t_tok, c.output_size)).astype(np.float32),
            "speech_feat_len": 2 * tl,
            "embedding": rng.standard_normal((b, c.spk_embed_dim)).astype(np.float32)}


@pytest.fixture(scope="module")
def dp_group(tmp_path_factory):
    """The flow step on 2 processes (rows of 30 + 26 and 9 + 5 tokens: the
    two processes' counts differ 4 to 1), the host guards, and a GAN turn
    on 4 crops split 2 / 2; beside them JAX's step on ``make_mesh(dp=2)``
    and the port's one-process GAN turn."""
    jp = to_numpy(init_flow(jax.random.key(0), JCFG.flow))  # the steps donate their state
    batch = _flow_batch(3, (30, 26, 9, 5))
    key = jax.random.key(6)
    t_mel = batch["speech_feat"].shape[1]
    draws = {k: v.numpy() for k, v in flow_draws_from_key(key, 4, JCFG.flow.output_size,
                                                          t_mel).items()}
    j_tx = jax_optim.make_optimizer(J_TC)
    mesh = jax_mesh.make_mesh(dp=2, fsdp=1, devices=jax.devices()[:2])
    with mesh:
        j_state = jax_ts.init_train_state(jax_mesh.shard_params(_jnp(jp), mesh), j_tx)
        j_state, j_m = jax_ts.make_flow_train_step(JCFG.flow, J_TC, j_tx)(
            j_state, jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
            key, streaming=False)
    want = {"metrics": to_numpy(j_m), "params": to_numpy(j_state.params),
            "mu": _mu(j_state.opt_state)}

    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.train import gan as port_gan

    gen = init_hift(torch.Generator().manual_seed(0), PCFG.hift)
    disc = port_gan.init_discriminator(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    s = JCFG.mel.hop_size * 8
    gan_batch = {"speech": (rng.standard_normal((4, s)) * 0.1).astype(np.float32),
                 "speech_feat": rng.standard_normal((4, 8, JCFG.hift.in_channels))
                 .astype(np.float32),
                 "pitch_feat": (np.abs(rng.standard_normal((4, 8))) * 200).astype(np.float32)}
    gan_draws = tuple(x.numpy() for x in hift_draws_from_key(jax.random.key(2))(
        4, s, JCFG.hift.nb_harmonics + 1))
    gan = {"gen": to_numpy(gen), "disc": to_numpy(disc), "batch": gan_batch, "draws": gan_draws}
    tx = port_optim.make_optimizer(port_train_gan.GAN_TRAIN_CONFIG)
    gen_step, disc_step = port_train_gan.make_gan_steps(PCFG, tx, tx)
    pb = {k: torch.tensor(v) for k, v in gan_batch.items()}
    pd = tuple(torch.tensor(x) for x in gan_draws)
    d2, opt_d, m_d = disc_step(disc, tx.init(disc), gen, pb, pd)
    g2, opt_g, m_g = gen_step(gen, tx.init(gen), d2, pb, pd)
    one = {"disc": (to_numpy(d2), to_numpy(opt_d["mu"]), to_numpy(m_d)),
           "gen": (to_numpy(g2), to_numpy(opt_g["mu"]), to_numpy(m_g))}

    ranks = W.run_group(W.dp_flow_and_guards, 2, tmp_path_factory.mktemp("dp"),
                        flow_cfg=PCFG.flow, params=jp, batch=batch, draws=draws,
                        train_cfg=P_TC, gan_cfg=PCFG, gan=gan)
    return ranks, want, one, batch


def test_dp_flow_step_matches_jax_dp2(dp_group):
    ranks, want, _, _ = dp_group
    assert [r["coords"] for r in ranks] == [(0, 0), (1, 0)]
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                                   rtol=1e-5)
        assert set(r["metrics"]) == {"loss", "grad_norm"}
        _close(r["mu"], want["mu"], GRAD_REL, GRAD_ABS)
        _close_after_adam(r["params"], want["params"], want["mu"], LR)
    for a, b in zip(tree_leaves(ranks[0]["params"]), tree_leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(a, b)  # the processes stay in step, bit for bit


def test_dp_flow_loss_is_not_the_mean_of_the_processes_means(dp_group):
    """The two processes' masked counts differ (56 + 52 against 18 + 10 mel
    frames), so DDP's mean of their means is another number than JAX's
    global loss; weighting by the counts gives JAX's."""
    ranks, want, _, batch = dp_group
    counts = [batch["speech_feat_len"][:2].sum(), batch["speech_feat_len"][2:].sum()]
    assert counts[0] > 3 * counts[1]
    plain = np.mean([r["local_loss"] for r in ranks])
    weighted = sum(r["local_loss"] * c for r, c in zip(ranks, counts)) / sum(counts)
    np.testing.assert_allclose(weighted, want["metrics"]["loss"], rtol=LOSS_RTOL)
    assert abs(plain - want["metrics"]["loss"]) > 100 * LOSS_RTOL * abs(want["metrics"]["loss"])


def test_host_guards_over_the_group(dp_group):
    ranks = dp_group[0]
    assert [r["joined"] for r in ranks] == [[0, 1], [0, 1]]
    assert [r["broadcast"] for r in ranks] == [([0.0] * 3, 0, "rank0")] * 2
    assert [r["agree"] for r in ranks] == [(True, False)] * 2


def _close_after_adam(got, want, mu, lr):
    for g, w, m in zip(tree_leaves(got), tree_leaves(want), tree_leaves(mu)):
        m = np.abs(m)
        sure = m > GRAD_REL * m.max(initial=0.0) + 0.1 * GRAD_ABS
        err = np.abs(g - w)
        assert (err[sure] <= 0.05 * lr).all() and (err <= 2.0 * lr + 1e-7).all()


def test_dp_gan_turns_match_the_one_process_turns(dp_group):
    """A discriminator turn then a generator turn on 4 crops split 2 / 2:
    the metrics (the TPR median over all 4 rows) within 1e-5, the
    gradients within the gradient tolerance, the parameters after Adam's
    first step as in tests/test_torch_gan.py."""
    ranks, _, one, _ = dp_group
    lr = port_train_gan.GAN_TRAIN_CONFIG.lr
    for r in ranks:
        for turn in ("disc", "gen"):
            params, mu, metrics = r["gan"][turn]
            w_params, w_mu, w_metrics = one[turn]
            assert set(metrics) == set(w_metrics)
            for k in w_metrics:
                assert float(metrics[k]) == pytest.approx(float(w_metrics[k]), rel=LOSS_RTOL,
                                                          abs=1e-7), (turn, k)
            _close(mu, w_mu, GRAD_REL, 0.1 * GRAD_ABS)
            _close_after_adam(params, w_params, w_mu, lr)


# ---------------------------------------------------------------------------
# the sharded optimizer state at (dp=1, fsdp=2)
# ---------------------------------------------------------------------------

def _lm_rows(seed, n):
    rng = np.random.default_rng(seed)
    texts = [rng.integers(2, JCFG.llm.backbone.vocab_size, rng.integers(6, 13)).astype(np.int32)
             for _ in range(n)]
    speeches = [rng.integers(0, JCFG.llm.speech_token_size, int(len(x) * rng.uniform(3.2, 6)))
                .astype(np.int32) for x in texts]
    return texts, speeches


def _lm_batch(seed, n=4, pad_to=96):
    texts, speeches = _lm_rows(seed, n)
    return jax_seq.build_lm_batch(texts, speeches, JCFG.llm, np.random.default_rng(seed), 0.5,
                                  pad_to)


def _dpo_batch(seed):
    chosen = _lm_batch(seed, 3, 100)
    texts, speeches = _lm_rows(seed, 3)
    rng = np.random.default_rng(seed + 50)
    rejected = jax_seq.build_lm_batch(
        texts, [rng.integers(0, JCFG.llm.speech_token_size, len(s)).astype(np.int32)
                for s in speeches], JCFG.llm, np.random.default_rng(seed), 0.5, 100)
    return dict(chosen, **{f"reject_{k}": v for k, v in rejected.items()})


@pytest.fixture(scope="module")
def fsdp_group(tmp_path_factory):
    jp = to_numpy(init_lm(jax.random.key(0), JCFG.llm))  # the steps donate their state
    batch, dpo_batch = _lm_batch(6), _dpo_batch(8)
    ref_j = jax.tree.map(lambda a: a * np.float32(1.01), jp)
    mesh = jax_mesh.make_mesh(dp=1, fsdp=2, devices=jax.devices()[:2])
    j_tx = jax_optim.make_optimizer(J_TC)
    with mesh:
        state = jax_ts.init_train_state(jax_mesh.shard_params(_jnp(jp), mesh), j_tx)
        state, m = jax_ts.make_lm_train_step(JCFG.llm, J_TC, j_tx)(
            state, jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        lm = {"metrics": to_numpy(m), "params": to_numpy(state.params),
              "mu": _mu(state.opt_state)}
        state = jax_ts.init_train_state(jax_mesh.shard_params(_jnp(jp), mesh), j_tx)
        state, m = jax_dpo.make_dpo_train_step(JCFG.llm, J_TC, j_tx, _jnp(ref_j), beta=0.1)(
            state, jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in dpo_batch.items()}, mesh))
        dpo = {"metrics": to_numpy(m), "params": to_numpy(state.params),
               "mu": _mu(state.opt_state)}
    # the JAX trainer at dp=2: the 3 rows padded to 4 (train.py::pad_batch_rows)
    mesh = jax_mesh.make_mesh(dp=2, fsdp=1, devices=jax.devices()[:2])
    with mesh:
        state = jax_ts.init_train_state(jax_mesh.shard_params(_jnp(jp), mesh), j_tx)
        padded = jax_train.pad_batch_rows(dpo_batch, 2)
        _, m = jax_dpo.make_dpo_train_step(JCFG.llm, J_TC, j_tx, _jnp(ref_j), beta=0.1)(
            state, jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in padded.items()}, mesh))
        dpo["padded_dp2"] = to_numpy(m)

    accum_tc = port_config.TrainConfig(lr=1e-3, accum_grad=2)
    accum_batches = [_lm_batch(20 + i) for i in range(3)]
    tx = port_optim.make_optimizer(accum_tc)
    state = port_ts.init_train_state(tree_map(torch.tensor, jp), tx)
    step = port_ts.make_lm_train_step(PCFG.llm, accum_tc, tx)
    losses = []
    for b in accum_batches:
        state, m = step(state, {k: torch.tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    one = {"losses": losses, "params": to_numpy(state.params),
           "mu": to_numpy(state.opt_state["mu"]), "acc_grads": to_numpy(state.opt_state["acc_grads"]),
           "mini_step": state.opt_state["mini_step"]}
    ranks = W.run_group(W.fsdp_lm, 2, tmp_path_factory.mktemp("fsdp"), lm_cfg=PCFG.llm,
                        params=jp, batch=batch, dpo_batch=dpo_batch,
                        ref_params=ref_j, train_cfg=P_TC, accum_cfg=accum_tc,
                        accum_batches=accum_batches)
    return ranks, lm, dpo, one, jp


def test_fsdp_lm_step_matches_jax(fsdp_group):
    """test_train.py::test_lm_train_step_sharded's step at (dp=1, fsdp=2),
    held to JAX's values: each process keeps half of each divisible leaf's
    moments, and the gathered moments and the parameters match."""
    ranks, lm, _, _, jp = fsdp_group
    whole = [x.shape for x in tree_leaves(jp)]
    for r in ranks:
        assert r["mu_shapes"] != whole
        assert sum(np.prod(s) for s in r["mu_shapes"]) < 0.6 * sum(np.prod(s) for s in whole)
        np.testing.assert_allclose(r["lm"]["metrics"]["loss"], lm["metrics"]["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["lm"]["metrics"]["acc"], lm["metrics"]["acc"], atol=1e-7)
        np.testing.assert_allclose(r["lm"]["metrics"]["grad_norm"], lm["metrics"]["grad_norm"],
                                   rtol=1e-5)
        _close(r["lm"]["mu"], lm["mu"], GRAD_REL, GRAD_ABS)
        _close_after_adam(r["lm"]["params"], lm["params"], lm["mu"], LR)
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1)]


def test_fsdp_dpo_step_weights_each_term_by_its_own_count(fsdp_group):
    """DPO's loss is a token mean (the CE) plus a row mean (the preference
    term): 3 rows split 2 / 1 weight the two terms by different shares."""
    ranks, _, dpo, _, _ = fsdp_group
    for r in ranks:
        for k in dpo["metrics"]:
            np.testing.assert_allclose(r["dpo"]["metrics"][k], dpo["metrics"][k],
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        _close(r["dpo"]["mu"], dpo["mu"], GRAD_REL, GRAD_ABS)
        _close_after_adam(r["dpo"]["params"], dpo["params"], dpo["mu"], LR)


def test_dpo_row_mean_counts_real_rows_only(fsdp_group):
    """At dp=2 the JAX trainer pads DPO's 3 rows to 4, and its row means
    count the pad row (a zero log-ratio: a preference loss of log 2, zero
    rewards).  The port's processes read their own rows unpadded, so its
    step at dp=2 is JAX's step on the 3 real rows (ROADMAP section 3)."""
    ranks, _, dpo, _, _ = fsdp_group
    padded = dpo["padded_dp2"]
    for r in ranks:
        got = r["dpo_dp2"]["metrics"]
        for k in dpo["metrics"]:
            np.testing.assert_allclose(got[k], dpo["metrics"][k], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        _close(r["dpo_dp2"]["mu"], dpo["mu"], GRAD_REL, GRAD_ABS)
        np.testing.assert_allclose(padded["dpo"], (3 * got["dpo"] + np.log(2)) / 4,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(padded["chosen_reward"], 3 * got["chosen_reward"] / 4,
                                   rtol=LOSS_RTOL, atol=1e-7)
        # the pad row moves the reward's mean by a quarter, far past the tolerance
        assert abs(padded["chosen_reward"] - got["chosen_reward"]) > \
            100 * (LOSS_RTOL * abs(got["chosen_reward"]) + 1e-7)


def test_fsdp_accumulated_steps_equal_one_process(fsdp_group):
    """3 steps of accum_grad=2 at fsdp=2 (one update, then half of the next
    mean) equal the one-process steps."""
    ranks, _, _, one, _ = fsdp_group
    for r in ranks:
        np.testing.assert_allclose(r["accum"]["losses"], one["losses"], rtol=LOSS_RTOL)
        assert r["accum"]["mini_step"] == one["mini_step"] == 1
        for k in ("mu", "acc_grads"):
            _close(r["accum"][k], one[k], GRAD_REL, GRAD_ABS)
        _close_after_adam(r["accum"]["params"], one["params"], one["mu"], LR)


def test_fsdp_state_is_adopted_once_into_flat_slices(fsdp_group):
    """At fsdp=2 each process's slices of the moments and the MultiSteps
    mean lie in one flat buffer a tree, copied there once over 3 steps of
    accum_grad=2 (the passes' layout of the slices)."""
    ranks, _, _, _, _ = fsdp_group
    for r in ranks:
        assert r["accum"]["adoptions"] == 1
        assert r["accum"]["storages"] == {"mu": 1, "nu": 1, "acc_grads": 1}


# ---------------------------------------------------------------------------
# the trainer: train.run --fsdp 2, checkpoints across fsdp sizes
# ---------------------------------------------------------------------------

def test_train_run_fsdp2_and_checkpoints_across_sizes(tmp_path):
    """``train.run --fsdp 2`` on 2 processes, each on its own 3 samples:
    the processes end in step, process 0 writes the checkpoints with the
    whole optimizer state, and it restores in one process and resumes
    there; a one-process checkpoint restores at fsdp 2 as each process's
    slices."""
    cfg = dataclasses.replace(PCFG, mel=dataclasses.replace(PCFG.mel, num_mels=16))
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(port_config.config_to_dict(cfg)))
    one_dir, two_dir = tmp_path / "one", tmp_path / "two"

    def args(model_dir, max_epoch=1, extra=()):
        return port_train.parse_args(
            ["--model", "flow", "--train_data", "x", "--cv_data", "x", "--config", str(cfg_path),
             "--max_epoch", str(max_epoch), "--max_frames_in_batch", "150", "--seed", "3",
             "--device", "cpu", "--model_dir", str(model_dir), *extra])

    samples = W._samples(100, 3)
    one = port_train.run(args(one_dir), lambda path, epoch: iter(samples))
    ranks = W.run_group(W.trainer_fsdp, 2, tmp_path, config_path=str(cfg_path),
                        model_dir=str(two_dir), world1_dir=str(one_dir))
    assert ranks[0]["steps"] == ranks[1]["steps"] >= 2
    for a, b in zip(tree_leaves(ranks[0]["params"]), tree_leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(a, b)

    # the one-process checkpoint, sliced as fsdp 2 slices it
    info = port_exec.latest_checkpoint(str(one_dir))
    whole = torch.load(str(one_dir / info["tag"]) + "-opt", weights_only=True)["mu"]
    for r, res in enumerate(ranks):
        for w, got in zip(tree_leaves(whole), tree_leaves(res["restored_mu"])):
            ax = port_mesh.param_sharding_spec(w.shape, 2)
            want = w if ax is None else w.chunk(2, ax)[r]
            np.testing.assert_array_equal(got, want.numpy())

    # the fsdp-2 checkpoint in one process: whole moments, the processes' params
    info = port_exec.latest_checkpoint(str(two_dir))
    assert info["has_opt"] and {i["tag"] for i in port_exec.list_checkpoints(str(two_dir))} == \
        {"epoch_0_whole"}
    template = port_ts.init_train_state(one["state"].params,
                                        port_optim.make_optimizer(port_config.TrainConfig()))
    restored = port_exec.restore_train_state(str(two_dir), info, template)
    for got, want in zip(tree_leaves(restored.params), tree_leaves(ranks[0]["params"])):
        np.testing.assert_array_equal(got.numpy(), want)
    assert [x.shape for x in tree_leaves(restored.opt_state["mu"])] == \
        [x.shape for x in tree_leaves(one["state"].params)]
    resumed = port_train.run(args(two_dir, 2, ["--resume"]), lambda path, epoch: iter(samples))
    assert resumed["executor"].step > ranks[0]["steps"]
