"""The port's slice as a whole against the JAX package, its entry point, and
its isolation from JAX (tiny config, fp32, CPU)."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_parity import hift_draws_from_key, jax_tts_params, lm_draws_from_key, to_numpy

import cosyvoice2_eu_torch as port
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.runtime import checkpoint as port_ckpt
from cosyvoice2_eu_torch.runtime import model as port_model
from cosyvoice2_eu_torch.utils.params import tree_leaves
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.runtime import model as jax_model

CFG = tiny_test_config()
PCFG = port_tiny()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    params = jax_tts_params(CFG, seed=0)
    jm = jax_model.TTSModel(CFG, params, seed=7, compute_dtype=None)
    pm = port_model.TTSModel(PCFG, to_numpy(params), seed=7, compute_dtype=None, device="cpu")
    return jm, pm


def _inputs(cls, seed=0):
    rng = np.random.default_rng(seed)
    n_sp = 6
    return cls(
        text_tokens=rng.integers(2, 200, 12).astype(np.int32),
        prompt_text_tokens=rng.integers(2, 200, 4).astype(np.int32),
        llm_prompt_speech_tokens=rng.integers(0, CFG.llm.speech_token_size, n_sp).astype(np.int32),
        flow_prompt_speech_tokens=rng.integers(0, CFG.flow.vocab_size, n_sp).astype(np.int32),
        prompt_feat=rng.standard_normal((n_sp * 2, CFG.flow.output_size)).astype(np.float32),
        embedding=rng.standard_normal(CFG.frontend.spk_embed_dim).astype(np.float32),
    )


def test_finalize_full_matches_jax(models):
    """Flow + HiFT from the same tokens, with the HiFT draws rebuilt from the
    key JAX's ``_next_rng`` hands out.  fp32 through 10 Euler steps and the
    vocoder: atol 1e-3 on audio clipped to +-0.99."""
    jm, pm = models
    tokens = np.random.default_rng(3).integers(0, CFG.flow.vocab_size, 70).astype(np.int32)
    _, k_hift = jax.random.split(jm._rng)  # what _next_rng will hand _hift_chunk
    want = jm._finalize_full(tokens, _inputs(jax_model.PromptInputs), {"hift_cache": None})
    got = pm._finalize_full(tokens, _inputs(port_model.PromptInputs), {"hift_cache": None},
                            hift_draws=hift_draws_from_key(k_hift))
    assert got.shape == want.shape == (70 * 2 * CFG.hift.upsample_scale,)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_tts_matches_jax_with_rebuilt_draws(models):
    """``tts(stream=False)`` end to end: the LM draws come from the first key
    ``_next_rng`` hands out and the HiFT draws from the second, so tokens are
    equal and the waveform agrees (fp32, atol 1e-3)."""
    jm, pm = models
    jm._rng = jax.random.key(21)
    r1, k_lm = jax.random.split(jm._rng)
    _, k_hift = jax.random.split(r1)
    want = np.concatenate(list(jm.tts(_inputs(jax_model.PromptInputs, 1), stream=False)))
    inputs = _inputs(port_model.PromptInputs, 1)
    _, _, _, p_bucket, _, max_len = pm._pack_lm_prompt(inputs)
    max_gen = min(((max_len + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)
    got = np.concatenate(list(pm.tts(
        inputs, lm_draws=lm_draws_from_key(k_lm, 1, max_gen, CFG.llm.top_k, CFG.llm.full_vocab),
        hift_draws=hift_draws_from_key(k_hift))))
    assert got.shape == want.shape and len(got) == pm.last_n_tokens * 2 * 480
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_load_tts_end_to_end_on_cpu():
    """The user's entry point on the CPU: audio of tokens x 960 samples."""
    model = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompt = {
        "prompt_feat": rng.standard_normal((12, PCFG.flow.output_size)).astype(np.float32),
        "speech_tokens": rng.integers(0, PCFG.llm.speech_token_size, 6).astype(np.int32),
        "embedding": rng.standard_normal(PCFG.frontend.spk_embed_dim).astype(np.float32),
    }
    for mode in ("cross_lingual", "zero_shot"):
        wav, sr = model.tts("Bonjour tout le monde.", prompt, mode=mode)
        n = model._model.last_n_tokens
        assert sr == 24000 and wav.shape == (1, n * 960) and n >= 2 * 22
        assert np.isfinite(wav).all() and np.abs(wav).max() <= PCFG.hift.audio_limit
    with pytest.raises(ValueError):
        model.tts("x", {"prompt_feat": prompt["prompt_feat"]})


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    """The card is the default: without one, load() and TTSModel raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.load(config=PCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_model.TTSModel(PCFG, {"llm": {}, "flow": {}, "hift": {}})


def test_cuda_device_turns_tf32_off(monkeypatch):
    """Choosing the card turns TF32 off for cuDNN convolutions and matmuls:
    HiFT's fp32 phase math does not tolerate it (cuDNN defaults it on)."""
    from cosyvoice2_eu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("what", ["model_dir", "tp", "wav_prompt", "instruct2"])
def test_paths_not_in_this_slice_raise(what, tmp_path, models, monkeypatch):
    """Paths of the JAX package that this slice lacks raise and name their
    ROADMAP item; they never do something else.  ``model_dir``: a model dir
    whose checkpoints are directories is read now (native checkpoints,
    ``tests/test_torch_native_checkpoint.py``): directories that hold no
    checkpoint raise ``ValueError`` naming what they hold, and the port's
    own ``save_pytree`` directories load the written parameters.  The two cases that
    were here before the prompt frontend was ported now hold it to the JAX
    package: a wav prompt on a model without a speech tokenizer raises its
    ``ValueError``, and ``mode="instruct2"`` gives JAX's audio (atol 1e-3)
    under JAX's draws.  ``tp``: tensor-parallel decode is ported
    (tests/test_torch_tp.py); ``load(tp=2)`` outside a process group of two
    raises ``ValueError`` instead of a ROADMAP item."""
    model = port.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    if what == "tp":
        with pytest.raises(ValueError, match="world size 1"):
            port.load(config=PCFG, device="cpu", tp=2)
        return
    if what == "wav_prompt":
        with pytest.raises(ValueError, match="no speech tokenizer available"):
            model.tts("x", np.zeros(16000, np.float32))
        return
    if what == "instruct2":
        from cosyvoice2_eu_tpu import Cosy2EU as JaxCosy2EU
        from cosyvoice2_eu_tpu.frontend.frontend import Frontend as JaxFrontend

        jm, pm = models
        japi = JaxCosy2EU(jm, JaxFrontend(CFG), CFG)
        papi = port.Cosy2EU(pm, model._frontend, PCFG)
        art = _inputs(dict)  # the prompt artifacts
        prompt = {"prompt_feat": art["prompt_feat"], "speech_tokens": art["flow_prompt_speech_tokens"],
                  "embedding": art["embedding"]}
        jm._rng = jax.random.key(5)
        r1, k_lm = jax.random.split(jm._rng)
        _, k_hift = jax.random.split(r1)
        inputs = model._frontend.frontend_instruct2("Bonjour.", "Parle lentement.", prompt)
        _, _, _, p_bucket, _, max_len = pm._pack_lm_prompt(inputs)
        max_gen = min(((max_len + 63) // 64) * 64, CFG.llm.max_seq_len - p_bucket)
        real = pm.tts
        monkeypatch.setattr(pm, "tts", lambda p, **kw: real(p, lm_draws=lm_draws_from_key(
            k_lm, 1, max_gen, CFG.llm.top_k, CFG.llm.full_vocab),
            hift_draws=hift_draws_from_key(k_hift), **kw))
        kw = dict(mode="instruct2", instruct_text="Parle lentement.")
        want, _ = japi.tts("Bonjour.", prompt, **kw)
        got, _ = papi.tts("Bonjour.", prompt, **kw)
        assert got.shape == want.shape == (1, pm.last_n_tokens * 960)
        np.testing.assert_allclose(got, want, atol=1e-3)
        return
    for key in ("llm", "flow", "hift"):
        (tmp_path / key).mkdir()
    with pytest.raises(ValueError, match=r"llm is neither .* holds \[\]"):
        port.load(config=PCFG, device="cpu", model_dir=str(tmp_path))
    for key in ("llm", "flow", "hift"):
        port_ckpt.save_pytree(str(tmp_path / key), model._model.params[key])
    loaded = port.load(config=PCFG, device="cpu", compute_dtype="float32",
                       model_dir=str(tmp_path))
    for key in ("llm", "flow", "hift"):
        for a, b in zip(tree_leaves(loaded._model.params[key]),
                        tree_leaves(model._model.params[key])):
            assert torch.equal(a, b)


def test_fade_in_out_matches_jax():
    """Hamming crossfade of chunk boundaries: exact (same numpy arithmetic)."""
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(40), rng.standard_normal(40)
    win = np.hamming(16)
    np.testing.assert_array_equal(port_model._fade_in_out(a, b, win),
                                  jax_model._fade_in_out(a, b, win))


def test_bucket_for_matches_jax():
    for n in (1, 64, 65, 300, 1024):
        assert port_model.bucket_for(n) == jax_model.bucket_for(n)
        assert port_model.bucket_for(n, port_model.FLOW_TOKEN_BUCKETS) == \
            jax_model.bucket_for(n, jax_model.FLOW_TOKEN_BUCKETS)
    with pytest.raises(ValueError):
        port_model.bucket_for(10_000)


def test_port_imports_no_jax():
    """Importing the port (and its entry module) loads neither JAX nor the JAX package."""
    code = ("import sys, cosyvoice2_eu_torch, cosyvoice2_eu_torch.runtime.model, "
            "cosyvoice2_eu_torch.frontend.frontend, cosyvoice2_eu_torch.ops.cuda_build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'cosyvoice2_eu_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package anywhere (also inside functions, which the import test cannot see)."""
    files = sorted(p for p in pathlib.Path(REPO, "cosyvoice2_eu_torch").rglob("*.py")
                   if "_build" not in p.parts)  # build output, not the package's code
    files.append(pathlib.Path(REPO, "chip_smoke.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "cosyvoice2_eu_tpu"), \
                    f"{path}: imports {name}"
