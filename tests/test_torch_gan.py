"""HiFT GAN training in the port against the JAX package (tiny HiFT, the
full-width discriminators, fp32, CPU): the discriminators' scores and
feature maps, every loss, both turns' losses and gradients, ``make_gan_steps``
against JAX's with the optax chain, and the GAN optimizer against that chain.

The parameters are drawn by the port and carried to JAX as numpy arrays; the
sine source's draws are JAX's, rebuilt from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch_parity import assert_trees_close, hift_draws_from_key, to_numpy

from cosyvoice2_eu_torch import config as port_config
from cosyvoice2_eu_torch.models.hift import init_hift
from cosyvoice2_eu_torch.parallel.train_step import value_and_grad
from cosyvoice2_eu_torch.train import gan as port_gan
from cosyvoice2_eu_torch.train import train_gan as port_train_gan
from cosyvoice2_eu_torch.train.optim import make_optimizer
from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map
from cosyvoice2_eu_tpu import config as jax_config
from cosyvoice2_eu_tpu.train import gan as jax_gan
from cosyvoice2_eu_tpu.train import train_gan as jax_train_gan

CFG, PCFG = jax_config.tiny_test_config(), port_config.tiny_test_config()
# the step losses within 1e-5 relative; each gradient leaf within 1e-4 of its
# largest JAX entry + 1e-7 (fp32, sums in another order)
LOSS_RTOL, GRAD_REL, GRAD_ABS = 1e-5, 1e-4, 1e-7
# forward values (scores, feature maps, losses): 1e-5 of the largest entry
FWD_REL, FWD_ABS = 1e-5, 1e-7
B, S = 2, CFG.mel.hop_size * 8  # two crops of 8 mel frames
KEY = jax.random.key(2)


def to_jax(tree):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)


@pytest.fixture(scope="module")
def setup():
    gen = init_hift(torch.Generator().manual_seed(0), PCFG.hift)
    disc = port_gan.init_discriminator(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    t = S // CFG.mel.hop_size
    batch = {
        "speech": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
        "speech_feat": rng.standard_normal((B, t, CFG.hift.in_channels)).astype(np.float32),
        "pitch_feat": (np.abs(rng.standard_normal((B, t))) * 200).astype(np.float32),
    }
    draws = hift_draws_from_key(KEY)(B, S, CFG.hift.nb_harmonics + 1)
    return dict(gen=gen, disc=disc, jgen=to_jax(gen), jdisc=to_jax(disc), batch=batch,
                pbatch={k: torch.tensor(v) for k, v in batch.items()}, draws=draws)


@pytest.fixture(scope="module")
def forward(setup):
    """Both packages' discriminator outputs on the real crops and a second,
    noisier pair standing in for the generated ones."""
    s = setup
    rng = np.random.default_rng(1)
    fake = (s["batch"]["speech"] + rng.standard_normal((B, S)) * 0.05).astype(np.float32)
    want = to_numpy(jax.jit(jax_gan.discriminator_forward)(s["jdisc"], s["batch"]["speech"], fake))
    got = port_gan.discriminator_forward(s["disc"], s["pbatch"]["speech"], torch.tensor(fake))
    return got, want


@pytest.mark.parametrize("part", ["scores_real", "scores_gen", "fmaps_real", "fmaps_gen"])
def test_discriminator_forward_matches_jax(forward, part):
    got, want = forward
    i = ["scores_real", "scores_gen", "fmaps_real", "fmaps_gen"].index(part)
    assert len(got[i]) == len(jax_gan.MPD_PERIODS) + len(jax_gan.MRD_FFT)
    assert_trees_close(got[i], want[i], FWD_REL, FWD_ABS)


@pytest.mark.parametrize("loss", ["generator_adv", "discriminator_adv", "feature", "tpr"])
def test_losses_match_jax(forward, loss):
    (yr, yg, fr, fg), (jyr, jyg, jfr, jfg) = forward
    fn = {
        "generator_adv": lambda m, a, b, c, d: m.generator_adv_loss(b),
        "discriminator_adv": lambda m, a, b, c, d: m.discriminator_adv_loss(a, b),
        "feature": lambda m, a, b, c, d: m.feature_loss(c, d),
        "tpr": lambda m, a, b, c, d: m.tpr_loss(b, a),
    }[loss]
    got = float(fn(port_gan, yr, yg, fr, fg))
    want = float(jax.jit(lambda *x: fn(jax_gan, *x))(jyr, jyg, jfr, jfg))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_multi_mel_loss_matches_jax(setup):
    real = setup["batch"]["speech"]
    gen = (real * 0.5 + 0.01).astype(np.float32)
    got = float(port_gan.multi_mel_loss(torch.tensor(real), torch.tensor(gen), PCFG.mel))
    want = float(jax_gan.multi_mel_loss(jnp.asarray(real), jnp.asarray(gen), CFG.mel))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_tpr_median_averages_the_middle_pair_on_an_even_count():
    """``jnp.median`` of [3, 1, 4, 2] is 2.5 where ``torch.median`` gives 2.0;
    the TPR loss centres on the former."""
    x = torch.tensor([3.0, 1.0, 4.0, 2.0])
    assert float(port_gan.median(x)) == 2.5 == float(jnp.median(jnp.asarray(x.numpy())))
    assert float(torch.median(x)) == 2.0
    assert float(port_gan.median(torch.tensor([3.0, 1.0, 2.0]))) == 2.0
    # an even-sized score: the losses agree with JAX, and not with a lower median
    dr = [torch.tensor([[0.9, 0.1, 0.5, 0.3]])]
    dg = [torch.tensor([[0.2, 0.4, 0.0, 0.1]])]
    got = float(port_gan.tpr_loss(dg, dr, tau=1.0))
    want = float(jax_gan.tpr_loss([jnp.asarray(dg[0].numpy())], [jnp.asarray(dr[0].numpy())],
                                  tau=1.0))
    assert got == pytest.approx(want, rel=1e-6)
    diff = dr[0] - dg[0]
    low = torch.median(diff)
    lower = float(torch.where(diff < low, (diff - low) ** 2, 0.0).sum()
                  / max(int((diff < low).sum()), 1))
    assert abs(got - lower) > 1e-3


def test_period_pad_repeats_the_edge_sample():
    """At a length that is not a multiple of the period, the pad is the last
    samples reversed ([..., 4, 4, 3]), not F.pad's reflect ([..., 4, 3, 2])."""
    x = torch.tensor([[[1.0, 2.0, 3.0, 4.0]]])
    assert port_gan._period_pad(x, 3).flatten().tolist() == [1, 2, 3, 4, 4, 3]
    assert F.pad(x, (0, 2), mode="reflect").flatten().tolist() == [1, 2, 3, 4, 3, 2]
    assert torch.equal(port_gan._period_pad(x, 2), x)


@pytest.mark.parametrize("period", [3, 7, 11])
def test_period_discriminator_at_a_ragged_length_matches_jax(setup, period):
    length = 1000  # not a multiple of 3, 7 or 11
    y = np.random.default_rng(period).standard_normal((2, length)).astype(np.float32) * 0.1
    i = jax_gan.MPD_PERIODS.index(period)
    got = port_gan._disc_p(setup["disc"]["mpd"][i], torch.tensor(y)[:, None], period)
    want = to_numpy(jax_gan._disc_p(setup["jdisc"]["mpd"][i], jnp.asarray(y)[:, None], period))
    assert_trees_close(got, want, FWD_REL, FWD_ABS)
    reflected = port_gan._disc_p(setup["disc"]["mpd"][i],
                                 F.pad(torch.tensor(y)[:, None], (0, (-length) % period),
                                       mode="reflect"), period)[0]
    assert not torch.allclose(reflected, got[0])


@pytest.mark.parametrize("turn", ["generator", "discriminator"])
def test_step_losses_and_gradients_match_jax(setup, jax_gan_steps, turn):
    """Each turn's loss, metrics and gradient at the point JAX's
    ``make_gan_steps`` took it (the generator's turn at JAX's updated
    discriminator); JAX's gradient is read from Adam's first moment, 0.1 x
    the gradient clipped to a global norm of 5."""
    s = setup
    if turn == "generator":
        disc2 = tree_map(torch.tensor, jax_gan_steps["disc"][0])
        (_, metrics), grads = value_and_grad(lambda p: port_gan.generator_step_loss(
            p, disc2, PCFG.hift, PCFG.mel, s["pbatch"], s["draws"]), s["gen"])
        _, want_mu, want_m = jax_gan_steps["gen"]
    else:
        (_, metrics), grads = value_and_grad(lambda p: port_gan.discriminator_step_loss(
            p, s["gen"], PCFG.hift, s["pbatch"], s["draws"]), s["disc"])
        _, want_mu, want_m = jax_gan_steps["disc"]
    assert set(metrics) == set(want_m)
    for k in want_m:
        assert float(metrics[k]) == pytest.approx(float(want_m[k]), rel=LOSS_RTOL), k
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in tree_leaves(grads)])))
    scale = 0.1 * min(1.0, 5.0 / norm)
    assert_trees_close(tree_map(lambda g: g * scale, grads), want_mu, GRAD_REL, scale * GRAD_ABS)


def test_discriminator_turn_computes_no_generator_gradient(setup):
    s = setup
    gen = tree_map(lambda x: x.detach().requires_grad_(True), s["gen"])
    loss, _ = port_gan.discriminator_step_loss(s["disc"], gen, PCFG.hift, s["pbatch"],
                                               s["draws"])
    assert not loss.requires_grad  # the generated waveform is detached
    loss_g, _ = port_gan.generator_step_loss(gen, s["disc"], PCFG.hift, PCFG.mel, s["pbatch"],
                                             s["draws"])
    assert loss_g.requires_grad


@pytest.fixture(scope="module")
def jax_gan_steps(setup):
    """One discriminator turn, then one generator turn, of JAX's
    ``make_gan_steps`` with the trainer's optax chain: each turn's new
    parameters, Adam's first moment and metrics."""
    s = setup
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(2e-4))
    gen_step, disc_step = jax_train_gan.make_gan_steps(CFG, tx, tx)
    gen, disc = to_jax(s["gen"]), to_jax(s["disc"])  # the steps donate their params
    disc2, opt_d, dm = disc_step(disc, tx.init(disc), gen, s["batch"], KEY)
    gen2, opt_g, gm = gen_step(gen, tx.init(gen), disc2, s["batch"], KEY)
    # chain(clip, adam) state: (clip's, (scale_by_adam's, scale_by_learning_rate's))
    return {"disc": to_numpy((disc2, opt_d[1][0].mu, dm)),
            "gen": to_numpy((gen2, opt_g[1][0].mu, gm))}


def _close_after_adam(got, want, mu, lr: float, path: str = ""):
    """A first Adam step moves an entry by lr x g / (|g| + 1e-8): where JAX's
    first moment (0.1 g) is clear of the gradient tolerance, the entry
    within 5% of lr; where it is not, the sign of g is not fixed, and the
    entry within 2 lr."""
    if isinstance(want, dict):
        for k in want:
            _close_after_adam(got[k], want[k], mu[k], lr, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, w in enumerate(want):
            _close_after_adam(got[i], w, mu[i], lr, f"{path}/{i}")
    else:
        g, w, m = got.detach().numpy(), np.asarray(want), np.abs(np.asarray(mu))
        sure = m > GRAD_REL * m.max(initial=0.0) + 0.1 * GRAD_ABS  # 0.1 x g's tolerance
        err = np.abs(g - w)
        assert (err[sure] <= 0.05 * lr).all() and (err <= 2.0 * lr + 1e-7).all(), \
            (path, float(err[sure].max(initial=0.0)), float(err.max(initial=0.0)))


def test_make_gan_steps_matches_jax(setup, jax_gan_steps):
    """One discriminator turn then one generator turn on the updated
    discriminator, each with JAX's draws: equal metrics, the gradients (read
    from Adam's first moment, 0.1 x the clipped gradient) within the
    gradient tolerance, and the parameters after the step."""
    s = setup
    tx = make_optimizer(port_train_gan.GAN_TRAIN_CONFIG)
    gen_step, disc_step = port_train_gan.make_gan_steps(PCFG, tx, tx)
    p_disc2, opt_d, p_dm = disc_step(s["disc"], tx.init(s["disc"]), s["gen"], s["pbatch"],
                                     s["draws"])
    p_gen2, opt_g, p_gm = gen_step(s["gen"], tx.init(s["gen"]), p_disc2, s["pbatch"],
                                   s["draws"])
    lr = port_train_gan.GAN_TRAIN_CONFIG.lr
    for (params, opt, metrics), (w_params, w_mu, w_metrics) in (
            ((p_disc2, opt_d, p_dm), jax_gan_steps["disc"]),
            ((p_gen2, opt_g, p_gm), jax_gan_steps["gen"])):
        for k in w_metrics:
            assert float(metrics[k]) == pytest.approx(float(w_metrics[k]), rel=LOSS_RTOL), k
        assert_trees_close(opt["mu"], w_mu, GRAD_REL, 0.1 * GRAD_ABS)
        _close_after_adam(params, w_params, w_mu, lr)
    assert not torch.equal(tree_leaves(p_gen2)[0], tree_leaves(s["gen"])[0])


def _optax_run(params, grads_seq):
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(2e-4))
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads_seq:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)
    return to_numpy(p)


def test_gan_optimizer_matches_the_optax_chain():
    """The port's Optimizer of ``TrainConfig(optim="adam", lr=2e-4,
    accum_grad=1, grad_clip=5.0)`` ("constantlr": no warm-up) against
    ``chain(clip_by_global_norm(5.0), adam(2e-4))`` over four steps, the
    third with a global norm above 5."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads_seq = []
    for scale in (0.1, 1.0, 10.0, 0.5):
        grads_seq.append({"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
                          "b": [(rng.standard_normal(5) * scale).astype(np.float32)]})
    assert float(np.sqrt(sum((x ** 2).sum() for x in (grads_seq[2]["a"], grads_seq[2]["b"][0])))) > 5
    tx = make_optimizer(port_train_gan.GAN_TRAIN_CONFIG)
    p = tree_map(torch.tensor, params)
    state = tx.init(p)
    for g in grads_seq:
        p, state = tx.step(p, tree_map(torch.tensor, g), state)
    assert_trees_close(p, _optax_run(params, grads_seq), 1e-6, 1e-7)


def test_gan_optimizer_skips_a_non_finite_step_where_optax_applies_it():
    """A documented divergence: the port's ``apply_if_finite`` skips a step
    whose gradient holds a NaN; the JAX package's chain applies it, and
    every parameter becomes NaN."""
    params = {"a": np.ones((2, 2), np.float32)}
    bad = {"a": np.array([[np.nan, 1.0], [1.0, 1.0]], np.float32)}
    tx = make_optimizer(port_train_gan.GAN_TRAIN_CONFIG)
    p = tree_map(torch.tensor, params)
    p2, state = tx.step(p, tree_map(torch.tensor, bad), tx.init(p))
    assert torch.equal(p2["a"], p["a"]) and state["total_notfinite"] == 1
    assert np.isnan(_optax_run(params, [bad])["a"]).all()


def test_make_gan_draws_shapes():
    batch = {"speech_feat": torch.zeros((3, 5, 16))}
    rand_ini, noise = port_gan.make_gan_draws(torch.Generator().manual_seed(0), batch,
                                              PCFG.hift)
    h = PCFG.hift.nb_harmonics + 1
    assert rand_ini.shape == (3, h) and noise.shape == (3, 5 * PCFG.hift.upsample_scale, h)


def test_turns_on_a_crop_whose_mel_was_trimmed_to_the_tokens(setup):
    """A fault of the JAX package, fixed in the port: the pipeline trims a
    crop's mel to two frames a speech token, so an odd frame count (the
    GAN crop of 24480 samples has 51) loses a frame and the generator makes
    one hop fewer samples than the crop; JAX cuts only the generated
    waveform and its turn fails on the shapes.  The port cuts both: the
    turn equals the port's on the crop cut to the mel."""
    s = setup
    t = S // CFG.mel.hop_size - 1
    cut = S - CFG.mel.hop_size
    batch = dict(s["batch"], speech_feat=s["batch"]["speech_feat"][:, :t],
                 pitch_feat=s["batch"]["pitch_feat"][:, :t])
    with pytest.raises((TypeError, ValueError)):  # traced only: the shapes fail
        jax.eval_shape(lambda: jax_gan.generator_step_loss(s["jgen"], s["jdisc"], CFG.hift,
                                                           CFG.mel, batch, KEY))
    draws = (s["draws"][0], s["draws"][1][:, :cut])
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    for loss_fn in (
            lambda b: port_gan.generator_step_loss(s["gen"], s["disc"], PCFG.hift, PCFG.mel, b,
                                                   draws),
            lambda b: port_gan.discriminator_step_loss(s["disc"], s["gen"], PCFG.hift, b, draws)):
        full, _ = loss_fn(pb)
        trimmed, _ = loss_fn(dict(pb, speech=pb["speech"][:, :cut]))
        assert torch.isfinite(full) and float(full) == float(trimmed)
