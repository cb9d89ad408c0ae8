"""The port's FSQ speech tokenizer and CAM++ (``models/speech_tokenizer.py``,
``models/campplus.py``) against the JAX package's on the CPU, on the JAX
package's parameters carried across by ``params_from_numpy``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_port

from cosyvoice2_eu_torch.models import campplus as port_cam
from cosyvoice2_eu_torch.models import speech_tokenizer as port_st
from cosyvoice2_eu_tpu.models import campplus as jax_cam
from cosyvoice2_eu_tpu.models import speech_tokenizer as jax_st

Z_TOL = 1e-5  # fp32 encoder, two attention blocks: z before the FSQ head
CAM_REL = 1e-5  # CAM++ embedding, relative to its largest value
FBANK_TOL = 5e-5  # log power of int16-scaled frames (|x| up to ~10)
PCFG, JCFG = port_st.tiny_tokenizer_config(), jax_st.tiny_tokenizer_config()
PCAM, JCAM = port_cam.tiny_campplus_config(), jax_cam.tiny_campplus_config()


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.fixture(scope="module")
def st_params():
    return to_numpy(jax_st.init_speech_tokenizer(jax.random.key(0), JCFG))


def _perturbed_bn(tree, rng):
    """BatchNorm statistics away from init's (mean 0, var 1, weight 1, bias
    0), so a swapped mean/var or a missing norm shows."""
    if isinstance(tree, dict):
        if set(tree) == {"weight", "bias", "mean", "var"}:
            c = tree["weight"].shape
            return {"weight": (0.5 + rng.random(c)).astype(np.float32),
                    "bias": (0.2 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.3 * rng.standard_normal(c)).astype(np.float32),
                    "var": (0.3 + 1.5 * rng.random(c)).astype(np.float32)}
        return {k: _perturbed_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed_bn(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def cam_params():
    return _perturbed_bn(to_numpy(jax_cam.init_campplus(jax.random.key(1), JCAM)),
                         np.random.default_rng(5))


def test_init_trees_have_the_jax_structure(st_params, cam_params):
    """``init_*`` from a ``torch.Generator`` build the JAX package's trees
    (paths and shapes), and the JAX trees enter the port unchanged through
    ``params_from_numpy``."""
    gen = torch.Generator().manual_seed(0)
    assert _shapes(port_st.init_speech_tokenizer(gen, PCFG)) == _shapes(st_params)
    assert _shapes(port_cam.init_campplus(gen, PCAM)) == _shapes(cam_params)
    for tree in (st_params, cam_params):
        ported = to_port(tree)
        assert _shapes(ported) == _shapes(tree)
        for a, b in zip(jax.tree.leaves(ported), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("frozen_table", [False, True])
@pytest.mark.parametrize("lengths", [[64, 40], [62, 37]])
def test_encode_matches_jax(st_params, frozen_table, lengths):
    """Codes equal and z within 1e-5, with the computed whisper positions
    or the table an ONNX export freezes (``positional_embedding``); padded
    codes are 0 and the code lengths follow the two stride-2 convs."""
    params = dict(st_params)
    if frozen_table:  # a table unlike the sinusoids, so that the branch shows
        params["positional_embedding"] = np.random.default_rng(1).standard_normal(
            (32, JCFG.d_model)).astype(np.float32)
    mel = np.random.default_rng(2).standard_normal((2, JCFG.n_mels, max(lengths)))
    mel = mel.astype(np.float32)
    want, want_len = jax_st.encode(params, JCFG, jnp.asarray(mel), jnp.asarray(lengths))
    got, got_len = port_st.encode(to_port(params), PCFG, torch.tensor(mel), torch.tensor(lengths))
    assert got.dtype == torch.int32 and got_len.tolist() == np.asarray(want_len).tolist()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z, valid, _ = port_st.encode_z(to_port(params), PCFG, torch.tensor(mel),
                                   torch.tensor(lengths))
    want_z = jax.jit(lambda p, m, n: _jax_z(p, m, n))(params, jnp.asarray(mel),
                                                     jnp.asarray(lengths))
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), atol=Z_TOL)
    assert valid.sum(1).tolist() == got_len.tolist()


def _jax_z(params, mel, mel_len):
    """JAX's ``encode`` up to ``project_down`` (its FSQ head taken off)."""
    out = {}
    real = jax_st.fsq_quantize

    def grab(z, levels):
        out["z"] = z
        return real(z, levels)

    jax_st.fsq_quantize = grab
    try:
        jax_st.encode(params, JCFG, mel, mel_len)
    finally:
        jax_st.fsq_quantize = real
    return out["z"]


def test_fsq_matches_jax_and_round_trips():
    """Codes equal JAX's (round half to even), and ``fsq_embed`` of the
    codes gives the quantized vector back (within 1e-6)."""
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((2, 7, 8)) * 2).astype(np.float32)
    z[0, 0] = np.arctanh(0.5 / jax_st.FSQ_TANH_SCALE)  # exactly at a rounding tie
    codes, quant = port_st.fsq_quantize(torch.tensor(z), 3)
    want_codes, want_quant = jax_st.fsq_quantize(jnp.asarray(z), 3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(quant.numpy(), np.asarray(want_quant), atol=1e-6)
    assert ((codes >= 0) & (codes < 3**8)).all()
    np.testing.assert_allclose(port_st.fsq_embed(codes, 8, 3).numpy(), quant.numpy(), atol=1e-6)
    np.testing.assert_allclose(port_st.fsq_embed(codes, 8, 3).numpy(),
                               np.asarray(jax_st.fsq_embed(want_codes, 8, 3)), atol=0)


def test_fsq_straight_through_gradient():
    z = torch.linspace(-2, 2, 8)[None, None].requires_grad_()
    port_st.fsq_quantize(z, 3)[1].sum().backward()
    assert torch.isfinite(z.grad).all() and z.grad.abs().sum() > 0


@pytest.mark.parametrize("t", [61, 37, 8])
def test_campplus_matches_jax(cam_params, t):
    """The embedding on perturbed BatchNorm statistics, at lengths that are
    not multiples of ``seg_len`` (8): the partial tail segment and the
    unbiased std; within 1e-5 of the largest value."""
    fbank = np.random.default_rng(t).standard_normal((2, t, JCAM.feat_dim)).astype(np.float32)
    want = np.asarray(jax_cam.campplus_forward(cam_params, JCAM, jnp.asarray(fbank)))
    got = port_cam.campplus_forward(to_port(cam_params), PCAM, torch.tensor(fbank)).numpy()
    assert got.shape == want.shape == (2, JCAM.embedding_size)
    assert np.abs(want).max() > 0.1  # the perturbed norms carry the signal
    np.testing.assert_allclose(got, want, atol=CAM_REL * np.abs(want).max())


@pytest.mark.parametrize("t,seg", [(13, 8), (16, 8), (5, 8), (100, 100), (101, 100)])
def test_seg_pool_matches_jax_and_torch_avg_pool(t, seg):
    """Segment means over each segment's true length, expanded back to T:
    JAX's and ``avg_pool1d(ceil_mode=True)``'s."""
    x = np.random.default_rng(t).standard_normal((2, 3, t)).astype(np.float32)
    got = port_cam._seg_pool(torch.tensor(x), seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_cam._seg_pool(jnp.asarray(x), seg)),
                               atol=1e-6)
    pooled = torch.nn.functional.avg_pool1d(torch.tensor(x), seg, seg, ceil_mode=True)
    np.testing.assert_allclose(got[:, :, ::seg].numpy(), pooled.numpy(), atol=1e-6)


def test_campplus_std_is_unbiased(cam_params):
    """The stats pooling's std divides by n - 1, as torch's ``std``: with
    ``var`` swapped for the biased one the embedding moves."""
    fbank = torch.tensor(np.random.default_rng(9).standard_normal((1, 21, 16)), dtype=torch.float32)
    params = to_port(cam_params)
    want = port_cam.campplus_forward(params, PCAM, fbank)
    real = torch.Tensor.var
    try:
        torch.Tensor.var = lambda x, dim, unbiased: real(x, dim=dim, unbiased=True)
        unbiased_twice = port_cam.campplus_forward(params, PCAM, fbank)
    finally:
        torch.Tensor.var = real
    assert not torch.allclose(want, unbiased_twice, atol=1e-7)


@pytest.mark.parametrize("n,bins", [(16000, 80), (7777, 16)])
def test_kaldi_fbank_cmn_matches_jax(n, bins):
    """int16 scaling, DC removal, povey window, 512-point power spectrum,
    htk mel from 20 Hz, log floor at float32 eps, utterance CMN."""
    wav = (np.random.default_rng(n).standard_normal((1, n)) * 0.1).astype(np.float32)
    got = port_cam.kaldi_fbank_cmn(torch.tensor(wav), bins).numpy()
    want = np.asarray(jax_cam.kaldi_fbank_cmn(jnp.asarray(wav), bins))
    assert got.shape == want.shape == (1, (n - 400) // 160 + 1, bins)
    np.testing.assert_allclose(got, want, atol=FBANK_TOL)
    np.testing.assert_allclose(got.mean(axis=1), 0.0, atol=1e-4)


def test_full_width_configs_match_jax():
    """The published widths: the tokenizer's 123,476,488 parameters and
    CAM++'s 6,931,104, from the port's own config and init."""
    for pcfg, jcfg in ((port_st.SpeechTokenizerConfig(), jax_st.SpeechTokenizerConfig()),
                       (port_cam.CAMPPlusConfig(), jax_cam.CAMPPlusConfig())):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    gen = torch.Generator().manual_seed(0)
    n_st = sum(p.numel() for p in jax.tree.leaves(
        port_st.init_speech_tokenizer(gen, port_st.SpeechTokenizerConfig())))
    n_cam = sum(p.numel() for p in jax.tree.leaves(
        port_cam.init_campplus(gen, port_cam.CAMPPlusConfig())))
    assert (n_st, n_cam) == (123_476_488, 6_931_104)
