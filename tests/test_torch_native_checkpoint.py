"""The port's native checkpoints against the JAX package's, on the CPU: the
orbax reader (``runtime/orbax_read.py``) bit-equal to orbax's own restore on
the trees the JAX package writes (tiny LM, flow and HiFT trees, bf16
leaves, a GAN whole tree, a leaf sharded over the 8 CPU devices of
``conftest.py``), the port's own ``save_pytree``/``load_pytree``, a model
directory that the JAX package's ``tools/extract_for_inference.py`` wrote
loading through the port's ``load(model_dir=...)`` with JAX's parameters and
audio, the port's extraction of its own trainer's output, and the errors."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from test_torch_stream import hift_key_chain
from torch_orbax_fixture import FIXTURE_DIR, flat, npz_leaves
from torch_parity import jax_tts_params, lm_draws_from_key, to_numpy

import cosyvoice2_eu_torch as port
import cosyvoice2_eu_tpu as cosy_jax
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.runtime import checkpoint as port_ckpt
from cosyvoice2_eu_torch.runtime import orbax_read
from cosyvoice2_eu_torch.tools import extract_for_inference as port_extract
from cosyvoice2_eu_torch.train import executor as port_executor
from cosyvoice2_eu_torch.utils.params import params_from_numpy, tree_leaves
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.runtime import checkpoint as jax_ckpt
from cosyvoice2_eu_tpu.train import executor as jax_executor
from tools import extract_for_inference as jax_extract

CFG = tiny_test_config()
PCFG = port_tiny()
RUN = "42-averaged-blanken-FR"


def _bits(x) -> np.ndarray:
    """A leaf's values as numpy, bf16 as its uint16 bits."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bit_equal(got, want, path=""):
    """Equal trees: the same structure (a tuple read back as a list), each
    array leaf of the same dtype and shape with the same bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, w in enumerate(want):
            _bit_equal(got[i], w, f"{path}/{i}")
    elif want is None or isinstance(want, (int, float)):
        assert got == want and type(got) is type(want), path
    else:
        g, w = _bits(got), _bits(want)
        assert torch.is_tensor(got) and g.dtype == w.dtype and g.shape == w.shape, path
        want_dtype = str(want.dtype).split(".")[-1] if torch.is_tensor(want) else \
            np.asarray(want).dtype.name
        assert str(got.dtype).split(".")[-1] == want_dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# the orbax reader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trees():
    params = jax_tts_params(CFG, seed=0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    rng = np.random.default_rng(1)
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((16, 4)), jnp.float32),
                             NamedSharding(mesh, PartitionSpec("x", None)))
    return {
        "llm": params["llm"],
        "llm_bf16": jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                                 if jnp.issubdtype(a.dtype, jnp.floating) else a, params["llm"]),
        "flow": params["flow"],
        "hift_whole": {"generator": params["hift"],
                       "discriminator": {"mpd": [np.ones((2, 3), np.float32)],
                                         "step": np.full((1,), 7, np.int32)}},
        "mixed": {"sharded": sharded, "nested": [[jnp.arange(5, dtype=jnp.int32)], (
            jnp.ones((2, 2), jnp.bfloat16), None)], "scalar": 2.5, "count": 3, "empty": {},
            "x.y": jnp.zeros((3,), jnp.float32)},
    }


@pytest.fixture(scope="module")
def orbax_dirs(tmp_path_factory, jax_trees):
    """Each tree written once by the JAX package's ``save_pytree``."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for name, tree in jax_trees.items():
        out[name] = str(root / name)
        jax_ckpt.save_pytree(out[name], tree)
    return out


@pytest.mark.parametrize("name", ["llm", "llm_bf16", "flow", "hift_whole", "mixed"])
def test_orbax_reader_is_bit_equal_to_orbax(orbax_dirs, jax_trees, name):
    """``load_pytree`` on the JAX package's orbax directory: the tree orbax
    itself restores and the one written, leaf for leaf, bit for bit."""
    got = port_ckpt.load_pytree(orbax_dirs[name])
    _bit_equal(got, jax_ckpt.load_pytree(orbax_dirs[name]))
    if name != "mixed":  # orbax gives Python numbers back for its scalars
        _bit_equal(got, jax_trees[name])


def test_sharded_leaf_has_several_chunks(orbax_dirs):
    """The (16, 4) leaf written from 8 devices sits in the store as 8
    chunks, which the reader assembles."""
    store = orbax_read.OcdbtStore(orbax_dirs["mixed"])
    chunks = sorted(k for k in store.entries if k.startswith(b"sharded/") and b".zarray" not in k)
    assert chunks == [f"sharded/{i}.0".encode() for i in range(8)]
    meta = json.loads(store.get("sharded/.zarray"))
    assert meta["chunks"] == [2, 4] and meta["shape"] == [16, 4]


def test_load_pytree_like_casts_and_places(orbax_dirs, jax_trees):
    like = params_from_numpy(to_numpy(jax_trees["flow"]), "cpu", torch.float64)
    got = port_ckpt.load_pytree(orbax_dirs["flow"], like=like)
    for g, w in zip(tree_leaves(got), tree_leaves(to_numpy(jax_trees["flow"]))):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w.astype(np.float64))


def test_ocdbt_store_reads_interior_nodes(tmp_path):
    """A database of B+tree height 2 with values inline and in data files
    (tensorstore's own writer at a small node size): every key and value
    as tensorstore reads them."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_inline_value_bytes": 16,
                                     "max_decoded_node_bytes": 300}}).result()
    txn = ts.Transaction()
    for i in range(40):
        kv.with_transaction(txn).write(f"key{i:03d}", (b"%d" % i) * (1 if i % 2 else 30)).result()
    txn.commit_async().result()
    store = orbax_read.OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert sorted(store.entries) == sorted(keys) and len(keys) == 40
    assert any(isinstance(v, tuple) for v in store.entries.values())
    for k in keys:
        assert store.get(k.decode()) == kv.read(k).result().value, k


def test_zstd_stream_decoder_equals_one_call(orbax_dirs):
    """The streaming decoder (for frames of unknown size) gives the bytes
    of the one-call decoder on a chunk of the store."""
    store = orbax_read.OcdbtStore(orbax_dirs["llm"])
    key = max((k for k in store.entries if not k.endswith(b".zarray")),
              key=lambda k: len(store.get(k.decode())))
    raw = store.get(key.decode())
    assert raw[:4] == b"\x28\xb5\x2f\xfd" and len(raw) > 1024
    assert orbax_read._stream_decompress(raw) == orbax_read.zstd_decompress(raw)


def test_missing_libzstd_raises(orbax_dirs, monkeypatch):
    monkeypatch.setattr(orbax_read, "ZSTD_LIBRARY", "libzstd_not_here.so.9")
    with pytest.raises(OSError, match="libzstd_not_here.so.9"):
        port_ckpt.load_pytree(orbax_dirs["flow"])


def test_committed_fixture_equals_its_npz():
    """``tests/data/orbax_fixture`` (the JAX package's orbax, read on the
    card by ``chip_smoke.py``) against the ``.npz`` of its values."""
    got = flat(port_ckpt.load_pytree(FIXTURE_DIR))
    want = npz_leaves()
    assert sorted(got) == sorted(want)
    for k, (dtype, bits) in want.items():
        assert str(got[k].dtype).split(".")[-1] == dtype, k
        np.testing.assert_array_equal(_bits(got[k]), bits, err_msg=k)


# ---------------------------------------------------------------------------
# native directories
# ---------------------------------------------------------------------------


def test_native_round_trip(tmp_path, jax_trees):
    tree = {"a": [torch.randn(3, 2), torch.ones(2, dtype=torch.bfloat16)],
            "b": {"c": np.arange(4, dtype=np.int32), "d": None, "e": 1.5}}
    port_ckpt.save_pytree(str(tmp_path / "t"), tree)
    assert sorted(os.listdir(tmp_path / "t")) == [port_ckpt.NATIVE_TREE_FILE]
    got = port_ckpt.load_pytree(str(tmp_path / "t"))
    _bit_equal(got, {"a": tree["a"], "b": {"c": torch.from_numpy(tree["b"]["c"]), "d": None,
                                           "e": 1.5}})


def test_neither_kind_raises(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "weights.bin").write_bytes(b"\0")
    with pytest.raises(ValueError, match=r"neither .* holds \['weights.bin'\]"):
        port_ckpt.load_pytree(str(tmp_path / "d"))


# ---------------------------------------------------------------------------
# extraction and load(model_dir=...)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_extracted(tmp_path_factory):
    """A model dir from the JAX package's training output: JAX's
    ``save_checkpoint`` into per-component experiment dirs (the LM's better
    checkpoint by CV loss second, a GAN whole tree for HiFT), then JAX's
    ``extract`` with a run id."""
    root = tmp_path_factory.mktemp("jax_run")
    params = jax_tts_params(CFG, seed=0)
    other = jax_tts_params(CFG, seed=5)
    exp = {k: str(root / f"{k}-fr") for k in ("llm", "flow", "hift")}
    for d in exp.values():
        os.makedirs(d)
    jax_executor.save_checkpoint(exp["llm"], "epoch_0_step_5", other["llm"], {"cv_loss": 2.0})
    jax_executor.save_checkpoint(exp["llm"], "epoch_1_step_10", params["llm"], {"cv_loss": 1.0})
    jax_executor.save_checkpoint(exp["flow"], "averaged-fr", params["flow"], {"cv_loss": 0.5})
    jax_executor.save_checkpoint(exp["hift"], "epoch_0_whole",
                                 {"generator": params["hift"],
                                  "discriminator": {"w": np.zeros((2, 2), np.float32)}},
                                 {"epoch": 0})
    model_dir = str(root / "model")
    jax_extract.extract(exp["llm"], "llm", model_dir, run_id=RUN)
    jax_extract.extract(exp["flow"], "flow", model_dir, run_id=RUN)
    jax_extract.extract(exp["hift"], "hifigan", model_dir, run_id=RUN)
    return model_dir, params, exp


def _load_kw(model_dir):
    return dict(model_dir=model_dir, seed=0, final=False, llm_run_id=RUN, flow_run_id=RUN,
                hifigan_run_id=RUN, compute_dtype="float32")


def test_jax_extracted_dir_loads_with_jax_params_and_audio(jax_extracted):
    """``load(model_dir=...)`` of the JAX-extracted orbax directories: JAX's
    parameters bit for bit, and ``tts`` under the JAX model's draws within
    1e-5 of JAX's ``load`` of the same directory."""
    model_dir, params, _ = jax_extracted
    api = port.load(config=PCFG, device="cpu", **_load_kw(model_dir))
    _bit_equal(api._model.params, params)
    japi = cosy_jax.load(config=CFG, **_load_kw(model_dir))
    prompt = {"prompt_feat": np.random.default_rng(0).standard_normal(
        (12, CFG.flow.output_size)).astype(np.float32),
        "speech_tokens": np.arange(6, dtype=np.int32),
        "embedding": np.ones(192, np.float32)}
    jm = japi._model
    jm._rng = jax.random.key(21)
    r1, k_lm = jax.random.split(jm._rng)
    text = "Bonjour tout le monde."
    want = np.concatenate(list(jm.tts(japi._frontend.frontend_cross_lingual(text, prompt),
                                      stream=False)))
    inputs = api._frontend.frontend_cross_lingual(text, prompt)
    pm = api._model
    _, _, _, p_bucket, _, max_len = pm._pack_lm_prompt(inputs)
    max_gen = min(((max_len + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)
    got = np.concatenate(list(pm.tts(
        inputs, lm_draws=lm_draws_from_key(k_lm, 1, max_gen, CFG.llm.top_k, CFG.llm.full_vocab),
        hift_draws=hift_key_chain(r1))))
    assert got.shape == want.shape and len(got) == pm.last_n_tokens * 960
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_port_extract_reads_a_jax_run(jax_extracted, tmp_path):
    """The port's extract over the JAX run's orbax ``<tag>`` directories:
    the same trees as JAX's extract wrote, now native."""
    model_dir, params, exp = jax_extracted
    out = port_extract.extract(exp["hift"], "hifigan", str(tmp_path), run_id=RUN)
    assert out == str(tmp_path / f"hift-{RUN}")
    assert os.listdir(out) == [port_ckpt.NATIVE_TREE_FILE]
    _bit_equal(port_ckpt.load_pytree(out), port_ckpt.load_pytree(
        os.path.join(model_dir, f"hift-{RUN}")))


def test_port_extract_over_port_trainer_output(tmp_path, capsys):
    """The port's trainer output (``train/executor.py`` files): the best by
    CV loss for the LM, the latest for a GAN run (its generator), ``--tag``
    and ``--final``; the model dir loads through ``load(model_dir=...)``."""
    from cosyvoice2_eu_torch.models.flow import init_flow
    from cosyvoice2_eu_torch.models.hift import init_hift
    from cosyvoice2_eu_torch.models.llm import init_lm

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    lm_a, lm_b = init_lm(gen(1), PCFG.llm), init_lm(gen(2), PCFG.llm)
    flow, hift0, hift1 = init_flow(gen(3), PCFG.flow), init_hift(gen(4), PCFG.hift), \
        init_hift(gen(5), PCFG.hift)
    exp = {k: str(tmp_path / k) for k in ("llm", "flow", "hift")}
    for d in exp.values():
        os.makedirs(d)
    port_executor.save_checkpoint(exp["llm"], "epoch_0_step_5", lm_a, {"cv_loss": 1.0,
                                                                       "epoch": 0, "step": 5})
    port_executor.save_checkpoint(exp["llm"], "epoch_1_step_9", lm_b, {"cv_loss": 3.0,
                                                                       "epoch": 1, "step": 9})
    port_executor.save_checkpoint(exp["flow"], "a", flow, {"cv_loss": 0.5})
    for e, g in ((0, hift0), (1, hift1)):
        port_executor.save_checkpoint(exp["hift"], f"epoch_{e}_whole",
                                      {"generator": g, "discriminator": {"w": torch.zeros(2)}},
                                      {"epoch": e}, opt_state={"m": torch.zeros(3)})
    model_dir = str(tmp_path / "model")
    assert port_extract.main(["--exp-dir", exp["llm"], "--component", "llm", "--out-dir",
                              model_dir, "--run-id", RUN]) == os.path.join(model_dir, f"llm-{RUN}")
    assert json.loads(capsys.readouterr().out) == {"written": os.path.join(model_dir,
                                                                          f"llm-{RUN}")}
    port_extract.extract(exp["flow"], "flow", model_dir, tag="a", run_id=RUN)
    port_extract.extract(exp["hift"], "hifigan", model_dir, run_id=RUN)
    final = port_extract.extract(exp["hift"], "hifigan", model_dir, tag="epoch_0_whole",
                                 final=True)
    assert final == os.path.join(model_dir, "hift")
    _bit_equal(port_ckpt.load_pytree(final), hift0)
    api = port.load(config=PCFG, device="cpu", **_load_kw(model_dir))
    for key, want in (("llm", lm_a), ("flow", flow), ("hift", hift1)):  # best, given, latest
        _bit_equal(api._model.params[key], want)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        port_extract.extract(str(tmp_path), "llm", model_dir)
