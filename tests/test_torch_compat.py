"""The port's reference-signature shim (``cosyvoice2_eu_torch/compat.py``)
against the JAX package's, over the same tiny models with a wav-capable
frontend (``load`` monkeypatched in both packages; nothing is read from
disk but the prompt)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_frontend import (  # noqa: F401 (fixtures)
    AUDIO_TOL,
    _under_jax_draws,
    apis,
    aux_params,
    fns,
    write_wav,
)

import cosyvoice2_eu_torch as port
import cosyvoice2_eu_tpu as cosy_jax
from cosyvoice2_eu_torch import compat as port_compat
from cosyvoice2_eu_tpu import compat as jax_compat
from cosyvoice2_eu_tpu.frontend import frontend as jax_fe


@pytest.fixture
def shims(apis, monkeypatch, tmp_path):  # noqa: F811
    papi, japi = apis
    calls = []
    monkeypatch.setattr(port, "load", lambda **kw: calls.append(kw) or papi)
    monkeypatch.setattr(cosy_jax, "load", lambda **kw: japi)
    md = str(tmp_path)
    return (port_compat.CosyVoice2(md, load_jit=True, backbone="blanken", device="cpu"),
            jax_compat.CosyVoice2(md, load_jit=True), calls)


def _prompt(tmp_path):
    path = write_wav(tmp_path / "prompt.wav", 0.4, seed=9)
    return torch.from_numpy(jax_fe.load_wav(path, 16000))[None]  # (1, N), as the reference


@pytest.mark.parametrize("method,stream", [("cross_lingual", True), ("zero_shot", False),
                                           ("instruct2", False)])
def test_inference_matches_jax(shims, apis, tmp_path, method, stream):  # noqa: F811
    """Each ``inference_*`` on a (1, N) 16 kHz tensor prompt, text normalised:
    dicts of (1, t) float32 CPU tensors, chunk for chunk within 1e-3 of
    the JAX package's under its draws; ``load`` got the constructor's
    arguments, the device included."""
    pc, jc, calls = shims
    prompt = _prompt(tmp_path)
    args = {"cross_lingual": ("Il y a 3 chats.", prompt),
            "zero_shot": ("Il y a 3 chats.", "Salut, ça va ?", prompt),
            "instruct2": ("Il y a 3 chats.", "Parle lentement.", prompt)}[method]
    _under_jax_draws(*apis, jax.random.key(41))
    got = list(getattr(pc, f"inference_{method}")(*args, stream=stream))
    want = list(getattr(jc, f"inference_{method}")(*args, stream=stream))
    assert len(got) == len(want) >= (2 if stream else 1)
    for g, w in zip(got, want):
        g, w = g["tts_speech"], w["tts_speech"]
        assert g.dtype == torch.float32 and g.device.type == "cpu" and g.shape == w.shape
        assert g.ndim == 2 and g.shape[0] == 1
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=AUDIO_TOL)
    assert calls[0]["device"] == "cpu" and calls[0]["backbone"] == "blanken"


def test_speakers_and_sft_match_jax(shims, apis, tmp_path):  # noqa: F811
    """``add_zero_shot_spk`` on a tensor prompt, ``list_available_spks``,
    ``inference_sft`` and ``inference_cross_lingual`` by speaker id (the
    same audio as JAX's), ``save_spkinfo`` into the model dir."""
    pc, jc, _ = shims
    for shim in (pc, jc):
        assert shim.add_zero_shot_spk("Salut.", _prompt(tmp_path), "alice")
        assert shim.list_available_spks() == ["alice"]
    for call in (lambda s: s.inference_sft("Oui, merci.", "alice"),
                 lambda s: s.inference_cross_lingual("Oui.", None, zero_shot_spk_id="alice")):
        _under_jax_draws(*apis, jax.random.key(42))
        got, want = list(call(pc)), list(call(jc))
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0]["tts_speech"].numpy(), want[0]["tts_speech"].numpy(),
                                   atol=AUDIO_TOL)
    pc.save_spkinfo()
    assert (tmp_path / "spk2info.npz").exists()
    for shim in (pc, jc):
        shim.frontend.spk_info.clear()


def test_unported_and_unsupported_raise():
    """The v1 class builds on ``load_v1`` (a tiny bundle on the CPU) and
    answers ``inference_sft``; ``CosyVoice2.inference_instruct`` raises."""
    from torch_parity import tiny_v1_bundle, tiny_v1_params

    from cosyvoice2_eu_torch import config as port_config

    cfg = tiny_v1_bundle(port_config)
    cv = port_compat.CosyVoice(config=cfg, params=tiny_v1_params(cfg), device="cpu")
    rng = np.random.default_rng(0)
    cv.frontend.add_zero_shot_spk("spk0", {
        "prompt_feat": rng.standard_normal((8, cfg.flow.output_size)).astype(np.float32),
        "speech_tokens": np.arange(5, dtype=np.int32),
        "embedding": rng.standard_normal(cfg.llm.spk_embed_dim).astype(np.float32)})
    out = list(cv.inference_sft("\x01\x02\x03", "spk0", text_frontend=False))
    assert len(out) == 1 and out[0]["tts_speech"].shape[0] == 1
    assert out[0]["tts_speech"].shape[1] % cfg.hift.upsample_scale == 0
    assert np.isfinite(out[0]["tts_speech"].numpy()).all()
    shim = object.__new__(port_compat.CosyVoice2)
    with pytest.raises(NotImplementedError, match="not implemented for CosyVoice2"):
        shim.inference_instruct("x")
