"""The optimizer over flat state buffers (``ops/optim_passes.py``,
``train/optim.py``): the step writes none of its arguments, a state is
adopted once (a restored checkpoint too, and each of two trees under one
optimizer), every leaf starts on a 256-byte boundary; on the card
(``cuda``-marked), passes A and B against their plain version.  No JAX:
the optax parity of the same chain is in ``test_torch_train.py`` and
``test_torch_gan.py``."""

import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch.config import TrainConfig
from cosyvoice2_eu_torch.ops import optim_passes as passes
from cosyvoice2_eu_torch.parallel import train_step as ts
from cosyvoice2_eu_torch.train.optim import global_norm, make_optimizer
from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map

# odd sizes, a 0-d leaf, a leaf past one kernel tile (8192 elements) and
# one that no gradient reaches
SHAPES = {"w": (5, 3), "blocks": [{"b": (7,)}, {"b": (130,), "s": ()}],
          "big": (300, 50), "unused": (2,)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


def _tree(rng, scale=1.0, device="cpu"):
    def leaf(shape):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.tensor(x, device=device)
    return _map(SHAPES, leaf)


def _map(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_map(v, fn) for v in shapes]
    return fn(shapes)


def _grads(rng, steps: int, inf_at: int, device="cpu") -> list:
    """Gradients of norm ~30-60 (the clip at 2 acts), the unused leaf 0, an
    inf at micro-step ``inf_at``."""
    out = []
    for i in range(steps):
        g = _tree(rng, 3.0, device)
        g["unused"] = torch.zeros(2, device=device)
        if i == inf_at:
            g["w"][1, 1] = float("inf")
        out.append(g)
    return out


def _config(optim: str, accum: int) -> TrainConfig:
    return TrainConfig(optim=optim, lr=1e-2, weight_decay=0.01 if optim == "adamw" else 0.0,
                       scheduler="warmuplr", warmup_steps=3, grad_clip=2.0, accum_grad=accum)


def _bytes(storage) -> torch.Tensor:
    return torch.empty(0, dtype=torch.uint8).set_(storage, 0, (storage.nbytes(),)).clone()


def _storages(*trees) -> dict:
    """A copy of the bytes of every storage under the trees' tensor leaves."""
    out = {}
    for tree in trees:
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                out.setdefault(st.data_ptr(), (st, _bytes(st)))
    return out


@pytest.mark.parametrize("optim", ["adam", "adamw"])
@pytest.mark.parametrize("accum", [1, 4])
def test_step_writes_none_of_its_arguments(optim, accum):
    """Two accumulation cycles (accum 4; 8 steps at accum 1), the clip
    active, an inf at one micro-step: every byte of every storage the step
    is given (parameters, gradients, each tree of the state, padding
    included) is unchanged after it, and the update still moves the
    parameters."""
    rng = np.random.default_rng(0)
    tx = make_optimizer(_config(optim, accum))
    params = _tree(rng)
    state = tx.init(params)
    first = [x.clone() for x in tree_leaves(params)]
    for g in _grads(rng, 8, inf_at=6):  # in the second cycle: the first one updates
        before = _storages(params, g, state)
        params, state = tx.step(params, g, state)
        for st, data in before.values():
            assert torch.equal(_bytes(st), data)
    assert state["total_notfinite"] == 1 and state["count"] == (7 if accum == 1 else 1)
    assert not any(torch.equal(a, b) for a, b in zip(first, tree_leaves(params))
                   if a.shape != (2,))


def test_restored_state_is_adopted_once_and_continues_bit_equal(tmp_path):
    """A state saved leaf by leaf mid-accumulation and restored into a new
    optimizer is adopted at its first step, once, and from there its run
    equals the uninterrupted flat run bit for bit (over an emission)."""
    rng = np.random.default_rng(1)
    cfg = _config("adamw", 4)
    grads = _grads(rng, 10, inf_at=-1)
    tx = make_optimizer(cfg)
    params = _tree(rng)
    state = tx.init(params)
    for g in grads[:3]:
        params, state = tx.step(params, g, state)
    clone = lambda tree: tree_map(  # noqa: E731
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)
    torch.save({"params": clone(params), "state": clone(state)}, tmp_path / "ckpt")
    saved = torch.load(tmp_path / "ckpt", weights_only=True)
    assert saved["params"]["w"].untyped_storage().nbytes() == 5 * 3 * 4  # one storage a leaf

    tx2 = make_optimizer(cfg)
    p2, s2 = saved["params"], saved["state"]
    before = passes.adopt.calls
    for g in grads[3:]:
        params, state = tx.step(params, g, state)
        p2, s2 = tx2.step(p2, g, s2)
    assert passes.adopt.calls - before == 1
    for a, b in zip(tree_leaves((params, state)), tree_leaves((p2, s2))):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_every_leaf_starts_on_a_256_byte_boundary():
    """The layout's offsets, and the parameter views a step returns, each a
    multiple of 256 bytes from the start of one buffer; the padding holds
    zeros."""
    rng = np.random.default_rng(2)
    tx = make_optimizer(_config("adam", 1))
    params, state = tx.step(_tree(rng), _grads(rng, 1, -1)[0], tx.init(_tree(rng)))
    leaves = tree_leaves(params)
    layout = passes.FlatLayout(leaves)
    assert all(o % 256 == 0 for o in layout.byte_offsets)
    base = leaves[0].data_ptr()
    assert [x.data_ptr() - base for x in leaves] == layout.byte_offsets
    flat = layout.flat_of(leaves)
    assert flat is not None and flat.numel() == layout.total
    pad = torch.ones(layout.total, dtype=torch.bool)
    for o, n in zip(layout.offsets, layout.numels):
        pad[o:o + n] = False
    assert pad.any() and not flat[pad].any()


def test_adoptions_are_one_per_tree():
    """One tree over two accumulation cycles adopts once; the GAN's two
    trees under one optimizer (accum 1, turns alternating) once each."""
    rng = np.random.default_rng(3)
    before = passes.adopt.calls
    tx = make_optimizer(_config("adamw", 4))
    params = _tree(rng)
    state = tx.init(params)
    for g in _grads(rng, 8, inf_at=-1):
        params, state = tx.step(params, g, state)
    assert passes.adopt.calls - before == 1

    before = passes.adopt.calls
    tx = make_optimizer(TrainConfig(optim="adam", lr=2e-4, accum_grad=1, grad_clip=5.0))
    gen = {"a": torch.ones(4, 3), "b": [torch.ones(5)]}
    disc = {"c": torch.ones(9)}
    opt_g, opt_d = tx.init(gen), tx.init(disc)
    for _ in range(3):
        disc, opt_d = tx.step(disc, tree_map(torch.ones_like, disc), opt_d)
        gen, opt_g = tx.step(gen, tree_map(torch.ones_like, gen), opt_g)
    assert passes.adopt.calls - before == 2 and opt_g["count"] == opt_d["count"] == 3


def test_grad_norm_metric_comes_from_pass_a():
    """make_step's ``grad_norm`` is pass A's norm of the gradient, within
    1e-6 of ``global_norm``, accumulating or emitting."""
    rng = np.random.default_rng(4)
    target = tree_leaves(_tree(rng))

    def loss_fn(p):
        loss = sum(((x - y) ** 2).sum() for x, y in zip(tree_leaves(p), target)
                   if x.shape != (2,))
        return loss, {"loss": loss}

    tx = make_optimizer(_config("adamw", 2))
    step = ts.make_step(loss_fn, tx)
    state = ts.init_train_state(_tree(rng), tx)
    for _ in range(3):
        grads = ts.value_and_grad(loss_fn, state.params)[1]
        state, m = step(state)
        assert float(m["grad_norm"]) == pytest.approx(float(global_norm(grads)), rel=1e-6)


@pytest.mark.cuda
def test_passes_on_the_card_match_the_plain_version(card):
    """Passes A and B on the card against the plain version on the CPU, over
    two accumulation cycles and two steps at accum 1: odd-sized leaves, a
    leaf past one tile, an unused leaf, gradients off a 16-byte boundary,
    a non-finite micro-step.  Each leaf of params, mu and nu within 1e-6
    relative; the gradient's norm and the emitted clip norm within 1e-6 of
    ``global_norm``; one pass-A launch a micro-step, one pass-B launch a
    finite emission, one adoption a run."""
    for accum, steps, inf_at, finite_emissions in ((4, 8, 5, 1), (1, 3, 1, 2)):
        rng = np.random.default_rng(5)
        cfg = _config("adamw", accum)
        grads = _grads(rng, steps, inf_at)
        p0 = _tree(rng)
        runs = {}
        for dev in ("cpu", card):
            tx = make_optimizer(cfg)
            params = tree_map(lambda x: x.to(dev), p0)
            state = tx.init(params)
            counts = (passes.accumulate.launches, passes.update.launches, passes.adopt.calls)
            seen = []
            for g in grads:
                if dev != "cpu":  # each leaf in a buffer of its own, 4 bytes past its start
                    g = tree_map(lambda x: torch.empty(x.numel() + 1, device=dev)[1:]
                                 .copy_(x.reshape(-1)).view(x.shape), g)
                params, state = tx.step(params, g, state)
                seen.append((float(tx.grad_norm), float(global_norm(g)),
                             [x.cpu() for x in tree_leaves((params, state["mu"], state["nu"]))]))
            runs[str(dev)] = seen, [a - b for a, b in zip(
                (passes.accumulate.launches, passes.update.launches, passes.adopt.calls), counts)]
        (cpu, cpu_counts), (gpu, gpu_counts) = runs["cpu"], runs[str(card)]
        assert cpu_counts == [0, 0, 1]
        assert gpu_counts == [steps, finite_emissions, 1]
        for (n_c, _, leaves_c), (n_g, ref_g, leaves_g) in zip(cpu, gpu):
            if np.isfinite(ref_g):
                assert n_g == pytest.approx(ref_g, rel=1e-6) and n_g == pytest.approx(n_c, rel=1e-6)
            for a, b in zip(leaves_g, leaves_c):
                err = (a - b).norm() / b.norm().clamp_min(1e-30)
                assert bool(torch.isfinite(a).all() == torch.isfinite(b).all())
                if torch.isfinite(b).all() and b.norm() > 0:
                    assert float(err) <= 1e-6

    # the emitted clip norm and the non-finite count, pass A against the plain version
    rng = np.random.default_rng(6)
    g = _grads(rng, 1, 0, card)[0]
    g["w"][1, 1] = 1.0
    leaves = tree_leaves(g)
    layout = passes.FlatLayout(leaves)
    a = layout.flatten(tree_leaves(_tree(rng, 1.0, card)))
    mean, sums = passes.accumulate(layout, leaves, a, 2, True)
    want_mean, want = passes.accumulate_reference(
        layout.flatten(leaves).cpu(), a.cpu(), 2, True)
    assert torch.equal(mean.cpu(), want_mean)
    assert sums.cpu().tolist() == pytest.approx(want.tolist(), rel=1e-6)
    assert float(sums[1]) == pytest.approx(float(global_norm(layout.views(mean))), rel=1e-6)
    a[7] = float("nan")
    assert float(passes.accumulate(layout, leaves, a, 2, True)[1][2]) == 1.0
