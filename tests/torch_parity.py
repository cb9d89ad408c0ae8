"""Shared helpers of the parity tests between the JAX package and the PyTorch port.

Parameters come from the JAX ``init_*`` functions, cross as numpy arrays and
enter the port through ``params_from_numpy``.  Random draws that JAX makes
from a key are rebuilt here from the same key chain and handed to the port,
whose samplers take them as inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice2_eu_torch.utils.params import params_from_numpy

# the suite runs in several pytest-xdist workers: keep each one's torch small
torch.set_num_threads(2)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(tree):
    """JAX parameter tree -> fp32 CPU tensors for the port."""
    return params_from_numpy(to_numpy(tree), "cpu", torch.float32)


def t(a, dtype=None) -> torch.Tensor:
    x = torch.tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def jax_tts_params(cfg, seed: int = 0) -> dict:
    """The {"llm", "flow", "hift"} tree ``cosyvoice2_eu_tpu.load`` builds from ``seed``."""
    from cosyvoice2_eu_tpu.models.flow import init_flow
    from cosyvoice2_eu_tpu.models.hift import init_hift
    from cosyvoice2_eu_tpu.models.llm import init_lm

    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    # jit: HiFT's many conv shapes compile faster as one program than op by op
    return {"llm": init_lm(k1, cfg.llm), "flow": init_flow(k2, cfg.flow),
            "hift": jax.jit(init_hift, static_argnums=1)(k3, cfg.hift)}


def lm_draws_from_key(rng, batch: int, steps: int, top_k: int, vocab: int):
    """The Gumbel draws ``lm_decode`` makes from ``rng``, as the port's ``draws(step)``.

    Chain: llm.py ``_sample_tokens`` splits (rng, sub) each step and ``sub``
    into one key per row; ``ras_sample`` splits a row key into the nucleus
    and full-vocabulary keys; ``categorical`` adds ``gumbel(key, shape)``.
    """
    nuc, full = [], []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, batch)
        pairs = [jax.random.split(k) for k in keys]
        nuc.append(np.stack([np.asarray(jax.random.gumbel(p[0], (top_k,), jnp.float32))
                             for p in pairs]))
        full.append(np.stack([np.asarray(jax.random.gumbel(p[1], (vocab,), jnp.float32))
                              for p in pairs]))
    return lambda step: (torch.tensor(nuc[step]), torch.tensor(full[step]))


def hift_draws_from_key(rng):
    """The draws ``hift.sine_source`` makes from ``rng``, as the port's
    ``hift_draws(batch, length, harmonics)``."""

    def draws(batch, length, harmonics):
        k_phase, k_noise = jax.random.split(rng)
        rand_ini = jax.random.uniform(k_phase, (batch, harmonics), jnp.float32)
        noise = jax.random.normal(k_noise, (batch, length, harmonics), jnp.float32)
        return torch.tensor(np.asarray(rand_ini)), torch.tensor(np.asarray(noise))

    return draws


def flow_draws_from_key(rng, batch: int, n_mels: int, t_mel: int) -> dict:
    """The draws JAX's ``flow_loss_fn`` makes from ``rng``, as the port's draws dict.

    Chain: train_step.py ``flow_loss_fn`` splits rng into (k_cond, k_frac,
    k_cfm); losses.py ``cfm_loss`` splits k_cfm into (k_t, k_z, k_cfg).
    """
    k_cond, k_frac, k_cfm = jax.random.split(rng, 3)
    k_t, k_z, k_cfg = jax.random.split(k_cfm, 3)
    draws = {
        "u_cond": jax.random.uniform(k_cond, (batch,)),
        "u_frac": jax.random.uniform(k_frac, (batch,)),
        "u_t": jax.random.uniform(k_t, (batch, 1, 1), jnp.float32),
        "z": jax.random.normal(k_z, (batch, n_mels, t_mel), jnp.float32),
        "u_cfg": jax.random.uniform(k_cfg, (batch,)),
    }
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def assert_trees_close(got, want, rel: float, abs_: float, path: str = ""):
    """Per leaf: max|got - want| <= rel * max|want| + abs_ (torch tree vs numpy tree)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rel, abs_, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, w in enumerate(want):
            assert_trees_close(got[i], w, rel, abs_, f"{path}/{i}")
    else:
        g, w = got.detach().cpu().numpy(), np.asarray(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        err, peak = float(np.abs(g - w).max(initial=0.0)), float(np.abs(w).max(initial=0.0))
        assert err <= rel * peak + abs_, (path, err, peak)


@pytest.fixture
def cuda_device():
    """The GPU for tests marked ``cuda``; they skip on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")
