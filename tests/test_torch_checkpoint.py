"""Loading reference checkpoints in the port against the JAX package (tiny
config, CPU): the converters, the naming matrix, ``load(model_dir=...)``
end to end, and the speaker store.  The state dicts are written from the
JAX package's ``init_*`` parameters by ``chip_smoke.reference_state_dicts``,
the inverse of the converters that the card's checkpoint phase uses too."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_stream import hift_key_chain
from torch_parity import jax_tts_params, lm_draws_from_key, to_numpy

import chip_smoke
import cosyvoice2_eu_torch as port
import cosyvoice2_eu_tpu as cosy_jax
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.frontend.frontend import Frontend
from cosyvoice2_eu_torch.runtime import checkpoint as port_ckpt
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.frontend.frontend import Frontend as JaxFrontend
from cosyvoice2_eu_tpu.runtime import checkpoint as jax_ckpt

CFG = tiny_test_config()
PCFG = port_tiny()


@pytest.fixture(scope="module")
def params():
    return to_numpy(jax_tts_params(CFG, seed=0))


def _paths(tree):
    """{path: leaf as numpy} of a dict/list tree (of arrays or CPU tensors)."""
    return {k: np.asarray(v) for k, v in chip_smoke._by_path(tree).items()}


def _assert_trees(got, want, rtol=0.0):
    """The same paths; each leaf equal, or within ``rtol`` of the leaf's largest value."""
    g, w = _paths(got), _paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max(initial=0.0))
        assert err <= rtol * float(np.abs(w[k]).max(initial=0.0)), (k, err)


def _save_model_dir(path, params, spk=None):
    """A reference-format model dir: llm.pt, flow.pt, hift.pt (and spk2info.pt)."""
    os.makedirs(path, exist_ok=True)
    for name, sd in chip_smoke.reference_state_dicts(params).items():
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   os.path.join(path, f"{name}.pt"))
    if spk is not None:
        torch.save(spk, os.path.join(path, "spk2info.pt"))
    return str(path)


def _reference_spk(seed=0, n_sp=6):
    """A one-speaker store in the reference's spk2info.pt layout."""
    rng = np.random.default_rng(seed)
    return {"spk0": {
        "speech_feat": torch.from_numpy(
            rng.standard_normal((1, 2 * n_sp, CFG.flow.output_size)).astype(np.float32)),
        "speech_token": torch.from_numpy(rng.integers(0, CFG.llm.speech_token_size, (1, n_sp))),
        "llm_embedding": torch.from_numpy(rng.standard_normal((1, 192)).astype(np.float32)),
        "flow_embedding": torch.from_numpy(rng.standard_normal((1, 192)).astype(np.float32)),
    }}


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------


def test_convert_llm_and_flow_match_jax_and_invert(params):
    """The port's converters give the JAX package's trees (same paths, equal
    leaves) and the parameters the state dicts were written from; the keys
    they ignore (the tied lm_head, the flow's rand_noise buffer) are there."""
    sd = chip_smoke.reference_state_dicts(params)
    assert "llm.model.lm_head.weight" in sd["llm"] and "decoder.rand_noise" in sd["flow"]
    for name, cfg, pcfg in (("llm", CFG.llm, PCFG.llm), ("flow", CFG.flow, PCFG.flow)):
        got = getattr(port_ckpt, f"convert_{name}")(sd[name], pcfg)
        _assert_trees(got, getattr(jax_ckpt, f"convert_{name}")(sd[name], cfg))
        _assert_trees(got, params[name])


def test_convert_llm_qwen3_norms_match_jax():
    """A qwen3 backbone's per-head q_norm / k_norm are mapped."""
    from cosyvoice2_eu_tpu.models.llm import init_lm

    cfg = dataclasses.replace(CFG.llm, backbone=dataclasses.replace(CFG.llm.backbone,
                                                                    use_qk_norm=True))
    llm = to_numpy(init_lm(jax.random.key(1), cfg))
    assert "q_norm" in llm["backbone"]["layers"][0]
    sd = chip_smoke.reference_state_dicts({"llm": llm})["llm"]
    pcfg = dataclasses.replace(PCFG.llm, backbone=dataclasses.replace(PCFG.llm.backbone,
                                                                      use_qk_norm=True))
    got = port_ckpt.convert_llm(sd, pcfg)
    _assert_trees(got, jax_ckpt.convert_llm(sd, cfg))
    _assert_trees(got, llm)


@pytest.mark.parametrize("weight_norm,prefix", [("parametrizations", ""), ("weight_g", ""),
                                                ("parametrizations", "generator.")])
def test_convert_hift_matches_jax_and_folds(params, weight_norm, prefix):
    """HiFT's convs under weight norm in either spelling, and nested under
    ``generator.`` as a GAN-trained checkpoint: equal to the JAX package's
    conversion, and the folded weights within 1e-6 (relative) of the
    originals."""
    sd = chip_smoke.reference_state_dicts(params, weight_norm, prefix)["hift"]
    assert any(k.endswith("original0" if weight_norm == "parametrizations" else "weight_g")
               for k in sd)
    assert all(k.startswith(prefix) for k in sd) and f"{prefix}stft_window" in sd
    got = port_ckpt.convert_hift(sd, PCFG.hift)
    _assert_trees(got, jax_ckpt.convert_hift(sd, CFG.hift))
    _assert_trees(got, params["hift"], rtol=1e-6)


@pytest.mark.parametrize("name", ["llm", "flow", "hift"])
def test_unmapped_key_raises(params, name):
    """A key no converter maps ends the conversion: ``ValueError`` in the
    port (an ``assert`` in the JAX package, which ``python -O`` would drop)."""
    sd = dict(chip_smoke.reference_state_dicts(params)[name], **{"stray.weight": np.zeros(2)})
    cfg, pcfg = getattr(CFG, name), getattr(PCFG, name)
    with pytest.raises(ValueError, match=f"unmapped {name} keys: \\['stray.weight'\\]"):
        getattr(port_ckpt, f"convert_{name}")(sd, pcfg)
    with pytest.raises(AssertionError, match="stray.weight"):
        getattr(jax_ckpt, f"convert_{name}")(sd, cfg)



# ---------------------------------------------------------------------------
# the naming matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("setting", ["llm_flow_hifigan", "llm", "flow_hifigan", "hifigan",
                                     "original"])
def test_resolve_checkpoint_files_matches_jax(tmp_path, setting, final):
    """setting x run ids x final -> paths, as the JAX package resolves them,
    a native directory (``flow-r2``) where no ``.pt`` of its stem exists."""
    for name in ("llm.pt", "flow.pt", "hift.pt", "llm-original.pt", "flow-original.pt",
                 "hift-original.pt", "llm-r1.pt", "hift-r3.pt"):
        (tmp_path / name).touch()
    (tmp_path / "flow-r2").mkdir()
    for ids in ((None, None, None), ("r1", "r2", "r3"), ("r1", None, "r3")):
        got = port.resolve_checkpoint_files(str(tmp_path), setting, *ids, final=final)
        assert got == cosy_jax.resolve_checkpoint_files(str(tmp_path), setting, *ids, final=final)
        if not final and "flow" in setting and ids[1] == "r2":
            assert os.path.isdir(got["flow"])


def test_resolve_checkpoint_files_rejects_a_bad_setting(tmp_path):
    for resolve in (port.resolve_checkpoint_files, cosy_jax.resolve_checkpoint_files):
        with pytest.raises(ValueError, match="setting must be"):
            resolve(str(tmp_path), "llm_vocoder", final=False)


def test_load_refuses_native_directories(tmp_path, params):
    """A run id that resolves to the JAX package's training output (a
    directory) raises and names the ROADMAP item that ports its reader."""
    _save_model_dir(tmp_path, params)
    (tmp_path / "llm-r1").mkdir()
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        port.load(config=PCFG, device="cpu", model_dir=str(tmp_path), final=False, setting="llm",
                  llm_run_id="r1")


# ---------------------------------------------------------------------------
# load(model_dir=...) end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, params):
    return _save_model_dir(tmp_path_factory.mktemp("model"), params, spk=_reference_spk())


@pytest.fixture(scope="module")
def jax_api(model_dir):
    """The JAX package's ``load(model_dir=...)``: one model for the file."""
    return cosy_jax.load(model_dir=model_dir, config=CFG, seed=0, compute_dtype="float32")


def test_load_model_dir_equals_load_params(model_dir, params):
    """``load(model_dir=...)`` converts and builds exactly as ``load(params=...)``
    with the JAX converters' trees: equal parameters (LM and flow equal to
    the originals, HiFT within 1e-6), and ``tts`` bit for bit."""
    got = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32",
                    model_dir=model_dir)
    converted = jax_ckpt.load_reference_checkpoints(model_dir, CFG)
    _assert_trees(port_ckpt.load_reference_checkpoints(model_dir, PCFG), converted)
    want = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32",
                     params=converted)
    _assert_trees(got._model.params, want._model.params)
    _assert_trees({k: got._model.params[k] for k in ("llm", "flow")},
                  {k: params[k] for k in ("llm", "flow")})
    _assert_trees(got._model.params["hift"], params["hift"], rtol=1e-6)
    prompt = got._frontend.get_spk("spk0")
    a, _ = got.tts("Bonjour.", prompt)
    b, _ = want.tts("Bonjour.", prompt)
    assert a.shape == b.shape == (1, got._model.last_n_tokens * 960)
    np.testing.assert_array_equal(a, b)


def test_load_model_dir_tts_matches_jax(model_dir, jax_api):
    """The same model dir through both packages' ``load``, then ``tts`` with
    the store's speaker under the draws of the JAX model's key chain: equal
    tokens, audio atol 1e-3."""
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32",
                    model_dir=model_dir)
    jm = jax_api._model
    jm._rng = jax.random.key(21)
    r1, k_lm = jax.random.split(jm._rng)
    text = "Bonjour tout le monde."
    want = np.concatenate(list(jm.tts(jax_api._frontend.frontend_cross_lingual(
        text, jax_api._frontend.get_spk("spk0")), stream=False)))
    inputs = api._frontend.frontend_cross_lingual(text, api._frontend.get_spk("spk0"))
    pm = api._model
    _, _, _, p_bucket, _, max_len = pm._pack_lm_prompt(inputs)
    max_gen = min(((max_len + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)
    got = np.concatenate(list(pm.tts(
        inputs, lm_draws=lm_draws_from_key(k_lm, 1, max_gen, CFG.llm.top_k, CFG.llm.full_vocab),
        hift_draws=hift_key_chain(r1))))
    assert got.shape == want.shape and len(got) == pm.last_n_tokens * 960
    np.testing.assert_allclose(got, want, atol=1e-3)


# ---------------------------------------------------------------------------
# the speaker store
# ---------------------------------------------------------------------------


def _same_store(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for spk in want:
        assert sorted(got[spk]) == sorted(want[spk])
        for k, v in want[spk].items():
            if isinstance(v, str):
                assert got[spk][k] == v
            else:
                assert got[spk][k].dtype == v.dtype
                np.testing.assert_array_equal(got[spk][k], v)


def test_reference_speaker_store_loads_like_jax(model_dir, jax_api):
    """``spk2info.pt`` in the reference's layout (speech_feat, speech_token,
    llm/flow_embedding, batch dims of 1) loads to the JAX package's artifacts;
    ``load(model_dir=...)`` reads it."""
    fe = Frontend(PCFG, device="cpu")
    fe.load_spk_info(os.path.join(model_dir, "spk2info.pt"))
    _same_store(fe.spk_info, jax_api._frontend.spk_info)
    art = fe.get_spk("spk0")
    assert art["prompt_feat"].shape == (12, CFG.flow.output_size)
    assert art["speech_tokens"].shape == (6,) and art["embedding"].shape == (192,)
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32",
                    model_dir=model_dir)
    _same_store(api._frontend.spk_info, fe.spk_info)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_speaker_store_round_trip_matches_jax(tmp_path, fmt):
    """``Cosy2EU.add_zero_shot_spk`` on a dict prompt, then the store saved
    (``.npz``) or written as the reference writes it (``.pt``) and loaded
    back: the same artifacts in the port and in the JAX package."""
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    rng = np.random.default_rng(3)
    prompt = {"prompt_feat": rng.standard_normal((12, 80)).astype(np.float32),
              "speech_tokens": rng.integers(0, 81, 6).astype(np.int32),
              "embedding": rng.standard_normal(192).astype(np.float32),
              "prompt_text": "Salut."}
    assert api.add_zero_shot_spk("", prompt, "alice") is True
    assert api._frontend.get_spk("alice") is prompt
    path = str(tmp_path / f"spk2info.{fmt}")
    if fmt == "npz":
        api._frontend.save_spk_info(path)
    else:
        torch.save({"alice": {"speech_feat": torch.from_numpy(prompt["prompt_feat"][None]),
                              "speech_token": torch.from_numpy(prompt["speech_tokens"][None]),
                              "flow_embedding": torch.from_numpy(prompt["embedding"][None])}},
                   path)
    fe, jfe = Frontend(PCFG, device="cpu"), JaxFrontend(CFG)
    fe.load_spk_info(path)
    jfe.load_spk_info(path)
    _same_store(fe.spk_info, jfe.spk_info)
    want = dict(prompt, prompt_text="" if fmt == "pt" else "Salut.")
    _same_store(fe.spk_info, {"alice": want})


def test_broken_speaker_store_raises(tmp_path, params):
    """A store that does not load ends ``load`` (the JAX package logs it and
    goes on without the store)."""
    _save_model_dir(tmp_path, params)
    (tmp_path / "spk2info.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception, match="pickle|zip|load"):
        port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32",
                  model_dir=str(tmp_path))
