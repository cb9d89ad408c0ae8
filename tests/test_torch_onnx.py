"""The port's ONNX frontend path against the JAX package's on the CPU: the
protobuf reader, the structural converters (separate and fused QKV, a
graph padded with plumbing nodes, CAM++ with its config inferred), codes
equal to the graph's own (JAX's numpy executor runs it), and
``load(model_dir=...)`` with both ONNX files driving a wav prompt.  The
graphs come from ``tests/test_onnx_convert.py``'s builders.  Where the JAX
package falls back to its graph executor, so does the port."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from test_onnx_convert import build_campplus_onnx, build_tokenizer_onnx
from test_onnx_fallback import _perturb, build_unconvertible_tokenizer
from test_torch_checkpoint import _save_model_dir
from test_torch_frontend import _mel_at_flow_width, _under_jax_draws, assert_mel_close, write_wav
from torch_parity import jax_tts_params, to_numpy, to_port

import cosyvoice2_eu_torch as port
import cosyvoice2_eu_tpu as cosy_jax
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import speech_tokenizer as port_st
from cosyvoice2_eu_torch.runtime import onnx_convert as port_conv
from cosyvoice2_eu_torch.runtime.onnx_fallback import load_frontend_fns
from cosyvoice2_eu_torch.runtime.onnx_import import load_onnx
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models import campplus as jax_cam
from cosyvoice2_eu_tpu.ops.mel import whisper_log_mel
from cosyvoice2_eu_tpu.runtime import onnx_convert as jax_conv
from cosyvoice2_eu_tpu.runtime import onnx_fallback as jax_fallback
from cosyvoice2_eu_tpu.runtime.onnx_exec import run_graph
from cosyvoice2_eu_tpu.runtime.onnx_import import load_onnx as jax_load_onnx

CFG, PCFG = _mel_at_flow_width(tiny_test_config()), _mel_at_flow_width(port_tiny())
T_IN = 48  # whisper frames the tokenizer graph's frozen position table covers (0.48 s)
CAM = dataclasses.replace(jax_cam.tiny_campplus_config(), embedding_size=192)
CAM_FRAMES = (T_IN * 160 - 400) // 160 + 1  # the fbank frames of a 0.48 s prompt


def _same(got, want, path=""):
    """Equal trees: dicts, lists, numpy arrays (exactly), and plain values."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, w in enumerate(want):
            _same(got[i], w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, jax.Array)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    return {
        "separate": build_tokenizer_onnx(d / "sep.onnx", np.random.default_rng(0), t_in=T_IN),
        "fused": build_tokenizer_onnx(d / "fused.onnx", np.random.default_rng(1), t_in=T_IN,
                                      fused_qkv=True),
        "campplus": build_campplus_onnx(d / "cam.onnx", CAM, np.random.default_rng(2),
                                        t_in=CAM_FRAMES),
    }


@pytest.mark.parametrize("which", ["separate", "fused", "campplus"])
def test_load_onnx_equals_jax(graphs, which):
    """Initializers, nodes (attributes included), graph inputs, outputs and
    input types: the same as the JAX package's reader gives."""
    _same(load_onnx(graphs[which]), jax_load_onnx(graphs[which]))


@pytest.mark.parametrize("which", ["separate", "fused"])
@pytest.mark.parametrize("perturbed", [False, True])
def test_speech_tokenizer_conversion_equals_jax(graphs, which, perturbed):
    """The converted tree and config equal JAX's, also after Identity /
    float Cast plumbing and mangled names are spliced in."""
    model = load_onnx(graphs[which])
    if perturbed:
        model = _perturb(model)
    params, cfg = port_conv.convert_speech_tokenizer(model)
    want_params, want_cfg = jax_conv.convert_speech_tokenizer(model)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    _same(params, want_params)
    assert "positional_embedding" in params and cfg.num_heads == 4


def test_graph_passes_equal_jax(graphs):
    """``simplify_graph`` and ``fuse_layer_norms`` give JAX's node lists."""
    model = _perturb(load_onnx(graphs["separate"]))
    _same(port_conv.simplify_graph(model), jax_conv.simplify_graph(model))
    _same(port_conv.fuse_layer_norms(model), jax_conv.fuse_layer_norms(model))


@pytest.mark.parametrize("which", ["separate", "fused"])
def test_converted_tokenizer_is_token_exact(graphs, which):
    """The port's ``encode`` on the converted tree gives the graph's own
    codes, as JAX's executor computes them from the same whisper mel."""
    model = load_onnx(graphs[which])
    params, cfg = port_conv.convert_speech_tokenizer(model)
    wav = (np.random.default_rng(3).standard_normal(T_IN * 160) * 0.1).astype(np.float32)
    mel = np.asarray(whisper_log_mel(jax.numpy.asarray(wav[None]), n_mels=16))[:, :, :T_IN]
    want = run_graph(model, {"mel": mel})[0].reshape(-1)
    codes, code_len = port_st.encode(to_port(params), cfg, torch.tensor(mel), torch.tensor([T_IN]))
    assert int(code_len[0]) == len(want) == T_IN // 4
    np.testing.assert_array_equal(codes[0].numpy(), want.astype(np.int32))


@pytest.mark.parametrize("given", [False, True])
def test_campplus_conversion_equals_jax(graphs, given):
    """CAM++'s tree and config, inferred from the graph or given, equal JAX's."""
    model = load_onnx(graphs["campplus"])
    params, cfg = port_conv.convert_campplus(model, CAM if given else None)
    want_params, want_cfg = jax_conv.convert_campplus(model, CAM if given else None)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert (cfg.block_layers, cfg.fcm_blocks, cfg.embedding_size) == \
        (CAM.block_layers, CAM.fcm_blocks, 192)
    _same(params, want_params)


def test_unconvertible_graph_falls_back_to_the_executor_as_jax(tmp_path, caplog):
    """A topology the converter cannot map: the port's ``load_frontend_fns``
    goes on with its graph executor, with a warning, as JAX's does, and
    gives JAX's codes; ``strict=True`` raises; a missing file gives None."""
    import logging

    st_path = str(tmp_path / "speech_tokenizer_v2.onnx")
    build_unconvertible_tokenizer(st_path, np.random.default_rng(4))
    jax_st_fn, _ = jax_fallback.load_frontend_fns(st_path, None)
    with caplog.at_level(logging.WARNING):
        st_fn, cam_fn = load_frontend_fns(st_path, None, device="cpu")
    assert st_fn is not None and cam_fn is None
    assert any("falling back" in r.message for r in caplog.records)
    wav = (np.random.default_rng(8).standard_normal(T_IN * 160) * 0.05).astype(np.float32)
    codes = st_fn(wav)
    assert codes.dtype == np.int32 and len(codes) > 0
    np.testing.assert_array_equal(codes, jax_st_fn(wav))
    with pytest.raises(Exception):
        load_frontend_fns(st_path, None, strict=True, device="cpu")
    assert load_frontend_fns(str(tmp_path / "none.onnx"), None, device="cpu") == (None, None)


@pytest.fixture(scope="module")
def onnx_model_dir(tmp_path_factory, graphs):
    """A reference model dir: checkpoints, both ONNX files (the tokenizer
    with 81 codes, the tiny LM's speech vocabulary) and no speaker store."""
    d = tmp_path_factory.mktemp("model_dir")
    _save_model_dir(d, to_numpy(jax_tts_params(CFG, seed=0)))
    build_tokenizer_onnx(d / "speech_tokenizer_v2.onnx", np.random.default_rng(5), t_in=T_IN,
                         fsq=4)
    build_campplus_onnx(d / "campplus.onnx", CAM, np.random.default_rng(6), t_in=CAM_FRAMES)
    return str(d)


def test_load_model_dir_with_onnx_drives_a_wav_prompt(onnx_model_dir, tmp_path):
    """``load(model_dir=...)`` builds the frontend from both ONNX files: a
    wav prompt gives JAX's codes, mel and x-vector, and ``tts`` under JAX's
    draws gives its audio within 1e-3."""
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32",
                    model_dir=onnx_model_dir)
    japi = cosy_jax.load(config=CFG, seed=0, compute_dtype="float32", model_dir=onnx_model_dir)
    assert api._frontend.speech_tokenizer_fn is not None
    assert api._frontend.spk_embedding_fn is not None
    wav_path = write_wav(tmp_path / "prompt.wav", T_IN * 160 / 16000, seed=11)
    got, want = api._prepare(wav_path, "Salut."), japi._prepare(wav_path, "Salut.")
    np.testing.assert_array_equal(got["speech_tokens"], want["speech_tokens"])
    assert len(got["speech_tokens"]) == T_IN // 4
    assert_mel_close(got["prompt_feat"], want["prompt_feat"])
    np.testing.assert_allclose(got["embedding"], want["embedding"],
                               atol=1e-5 * np.abs(want["embedding"]).max())
    _under_jax_draws(api, japi, jax.random.key(3))
    a, _ = api.tts("Bonjour.", wav_path, prompt_text="Salut.", mode="zero_shot")
    b, _ = japi.tts("Bonjour.", wav_path, prompt_text="Salut.", mode="zero_shot")
    assert a.shape == b.shape == (1, api._model.last_n_tokens * 960)
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_load_model_dir_with_an_unconvertible_graph_falls_back_to_the_executor(
        onnx_model_dir, tmp_path):
    """``load(model_dir=...)`` with a tokenizer graph the converter cannot
    map runs it through the executor, as the JAX package's ``load``: a wav
    prompt gives JAX's codes and x-vector."""
    d = tmp_path / "dir"
    d.mkdir()
    for name in ("llm.pt", "flow.pt", "hift.pt", "campplus.onnx"):
        os.symlink(os.path.join(onnx_model_dir, name), d / name)
    build_unconvertible_tokenizer(str(d / "speech_tokenizer_v2.onnx"), np.random.default_rng(7))
    api = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32", model_dir=str(d))
    japi = cosy_jax.load(config=CFG, seed=0, compute_dtype="float32", model_dir=str(d))
    wav_path = write_wav(tmp_path / "prompt.wav", T_IN * 160 / 16000, seed=12)
    got, want = api._prepare(wav_path, "Salut."), japi._prepare(wav_path, "Salut.")
    assert len(got["speech_tokens"]) > 0
    np.testing.assert_array_equal(got["speech_tokens"], want["speech_tokens"])
    np.testing.assert_allclose(got["embedding"], want["embedding"],
                               atol=1e-5 * np.abs(want["embedding"]).max())
