"""The tiny orbax checkpoint committed under ``tests/data/``: the tree,
written once with the JAX package's ``save_pytree`` (run this module to
rewrite it), and the ``.npz`` of its values beside it, which the port's
orbax reader is held to here and on the card (``chip_smoke.py``)."""

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE_DIR = os.path.join(DATA, "orbax_fixture")
FIXTURE_NPZ = os.path.join(DATA, "orbax_fixture.npz")


def fixture_tree():
    """fp32, bf16 and int32 leaves, nested dicts and a list, a key with a
    dot, a (16, 4) leaf sharded over 8 devices (8 chunks of (2, 4)), and a
    leaf past orbax's 1 KiB inline limit, which the store keeps in a data
    file."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((16, 4)), jnp.float32),
                             NamedSharding(mesh, PartitionSpec("x", None)))
    return {
        "enc": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
                "b": jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16)},
        "layers": [{"scale": jnp.asarray(rng.standard_normal((2, 2)), jnp.bfloat16)},
                   {"ids": jnp.arange(6, dtype=jnp.int32)}],
        "x.y": jnp.asarray(rng.standard_normal((7,)), jnp.float32),
        "sharded": sharded,
        "big": jnp.asarray(rng.standard_normal((48, 32)), jnp.float32),  # a value in a data file
    }


def flat(tree, prefix=""):
    """{"a/b/0": leaf} of a dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def write_npz(path, tree):
    """The leaves by path; a bf16 leaf as its uint16 bits under ``<path>@bf16``."""
    out = {}
    for k, v in flat(tree).items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            out[k + "@bf16"] = a.view(np.uint16)
        else:
            out[k] = a
    np.savez(path, **out)


def npz_leaves(path=FIXTURE_NPZ):
    """{path: (dtype name, numpy array of the values' bits or values)}."""
    with np.load(path) as z:
        return {k.split("@")[0]: ("bfloat16" if k.endswith("@bf16") else z[k].dtype.name, z[k])
                for k in z.files}


if __name__ == "__main__":  # rewrite the fixture (8 CPU devices, as tests/conftest.py sets)
    import shutil

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys

    sys.path.insert(0, os.path.dirname(DATA) + "/..")
    from cosyvoice2_eu_tpu.runtime.checkpoint import save_pytree

    shutil.rmtree(FIXTURE_DIR, ignore_errors=True)
    tree = fixture_tree()
    save_pytree(FIXTURE_DIR, tree)
    write_npz(FIXTURE_NPZ, tree)
