"""The port's ONNX graph executor (``runtime/onnx_exec.py``) and its
fallback frontend functions (``runtime/onnx_fallback.py``) against the JAX
package's, on the CPU: the op matrices of ``tests/test_onnx_convert.py`` and
``tests/test_onnx_fallback.py``, the convolutions and average pools (torch
here, XLA there) over asymmetric pads, strides, dilations, groups and ceil
mode, the tokenizer and CAM++ graphs run whole, the forced executor
(``COSY2EU_ONNX_EXECUTOR=1``) and strict mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from onnx_builder import GraphBuilder
from test_onnx_convert import _f32, _i64, build_campplus_onnx, build_tokenizer_onnx
from test_onnx_fallback import build_unconvertible_tokenizer

from cosyvoice2_eu_torch.runtime import onnx_exec as port_exec
from cosyvoice2_eu_torch.runtime import onnx_fallback as port_fallback
from cosyvoice2_eu_torch.runtime.onnx_import import load_onnx
from cosyvoice2_eu_tpu.models import campplus as jax_cam
from cosyvoice2_eu_tpu.ops.mel import whisper_log_mel
from cosyvoice2_eu_tpu.runtime import onnx_exec as jax_exec
from cosyvoice2_eu_tpu.runtime import onnx_fallback as jax_fallback

# 80 fbank bins: the executor's CAM++ features have the reference's width
CAM = dataclasses.replace(jax_cam.tiny_campplus_config(), feat_dim=80, embedding_size=192)
T_IN = 48  # whisper frames of the prompts (0.48 s), which the tokenizer graph's table covers
CAM_FRAMES = (T_IN * 160 - 400) // 160 + 1  # their fbank frames, frozen into CAM++'s graph


def _same_outputs(model, feeds, rtol=0.0, atol=0.0):
    """Every output of the port's executor against JAX's: the same dtype and
    shape, values within the tolerance (exact by default)."""
    got = port_exec.run_graph(model, feeds, device="cpu")
    want = jax_exec.run_graph(model, feeds)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=str(i))
    return got


def test_executor_op_matrix_equals_jax(tmp_path):
    """``test_onnx_convert.py::test_executor_op_matrix``'s graph: Gemm
    transB and beta, Slice to INT_MAX on a negative axis, Split, reflect
    Pad, Clip, Where/Equal, Pow and an int Cast."""
    g = GraphBuilder()
    w = g.init(np.arange(12, dtype=np.float32).reshape(2, 6))
    c = g.init(np.ones((2, 2), np.float32))
    gemm = g.add("Gemm", ["x", w, c], alpha=0.5, beta=2.0, transB=1)
    sl = g.add("Slice", ["x", g.init(_i64([1])), g.init(_i64([2147483647])),
                         g.init(_i64([-1])), g.init(_i64([1]))])
    s1, s2 = g.add("Split", ["x"], n_out=2, axis=1, num_outputs=2)
    pad = g.add("Pad", ["x", g.init(_i64([0, 1, 0, 1]))], mode=b"reflect")
    cl = g.add("Clip", ["x", g.init(_f32(-0.5)), g.init(_f32(0.5))])
    eq = g.add("Equal", ["x", g.init(_f32(0.0))])
    wh = g.add("Where", [eq, g.init(_f32(9.0)), "x"])
    cast = g.add("Cast", [g.add("Pow", ["x", g.init(_f32(2.0))])], to=6)
    path = g.save(str(tmp_path / "ops.onnx"), ["x"], [gemm, sl, s1, s2, pad, cl, wh, cast])
    xv = np.linspace(-1.5, 1.5, 12, dtype=np.float32).reshape(2, 6)
    outs = _same_outputs(load_onnx(path), {"x": xv})
    assert outs[7].dtype == np.int32


def test_executor_extended_ops_equal_jax(tmp_path):
    """``test_onnx_fallback.py::test_executor_extended_ops``'s graph: integer
    Div truncating, negative Gather indices, Sin/Cos, Mod (fmod),
    LeakyRelu, ArgMax, Trilu, Shape with a start; and Gelu, Softmax,
    LayerNormalization, Erf, TopK, CumSum, Expand, Tile, Range."""
    g = GraphBuilder()
    shp = g.add("Shape", ["x"])
    half = g.add("Div", [shp, g.init(np.asarray([1, 2], np.int64))])
    neg = g.add("Div", [g.init(np.asarray([-7, 7], np.int64)), g.init(np.asarray([2, -2],
                                                                                 np.int64))])
    gat = g.add("Gather", ["x", g.init(np.asarray([-1], np.int64))], axis=1)
    outs = [half, neg, gat, g.add("Sin", ["x"]), g.add("Cos", ["x"]),
            g.add("Mod", ["x", g.init(np.float32(1.5))], fmod=1),
            g.add("LeakyRelu", ["x"], alpha=0.1), g.add("ArgMax", ["x"], axis=1, keepdims=0),
            g.add("Trilu", ["x"], upper=0), g.add("Shape", ["x"], start=1),
            g.add("Gelu", ["x"]), g.add("Softmax", ["x"], axis=-1),
            g.add("LayerNormalization", ["x", g.init(np.full(6, 1.5, np.float32)),
                                         g.init(np.full(6, 0.25, np.float32))], axis=-1),
            g.add("Erf", ["x"]), g.add("CumSum", ["x", g.init(np.asarray([1], np.int64))]),
            g.add("Expand", [g.add("Gather", ["x", g.init(np.asarray([0], np.int64))], axis=0),
                             g.init(np.asarray([3, 6], np.int64))]),
            g.add("Tile", ["x", g.init(np.asarray([1, 2], np.int64))]),
            g.add("Range", [g.init(np.asarray(1, np.int64)), g.init(np.asarray(9, np.int64)),
                            g.init(np.asarray(3, np.int64))])]
    topv, topi = g.add("TopK", ["x", g.init(np.asarray([2], np.int64))], n_out=2, axis=1)
    path = g.save(str(tmp_path / "ops2.onnx"), ["x"], outs + [topv, topi])
    xv = np.linspace(-2, 2, 12, dtype=np.float32).reshape(2, 6)
    got = _same_outputs(load_onnx(path), {"x": xv})
    np.testing.assert_array_equal(got[0], [2, 3])
    np.testing.assert_array_equal(got[1], [-3, -3])  # truncation toward zero


@pytest.mark.parametrize("case", [
    dict(x=(2, 4, 19), w=(6, 4, 3), strides=[2], pads=[2, 1], dilations=[2], group=1),
    dict(x=(1, 6, 17), w=(6, 1, 5), strides=[1], pads=[4, 0], dilations=[1], group=6),
    dict(x=(2, 3, 9, 11), w=(4, 3, 3, 3), strides=[2, 1], pads=[1, 0, 2, 1], dilations=[1, 2],
         group=1),
])
def test_conv_equals_jax(tmp_path, case):
    """Conv through ``torch.nn.functional`` against XLA's, with and without
    a bias, at fp32 tolerance."""
    rng = np.random.default_rng(0)
    g = GraphBuilder()
    w = g.init(rng.standard_normal(case["w"]).astype(np.float32))
    b = g.init(rng.standard_normal(case["w"][0]).astype(np.float32))
    kw = {k: case[k] for k in ("strides", "pads", "dilations", "group")}
    y1 = g.add("Conv", ["x", w, b], **kw)
    y2 = g.add("Conv", ["x", w], **kw)
    path = g.save(str(tmp_path / "conv.onnx"), ["x"], [y1, y2])
    xv = rng.standard_normal(case["x"]).astype(np.float32)
    _same_outputs(load_onnx(path), {"x": xv}, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    dict(x=(2, 3, 17), kernel_shape=[3], strides=[2], pads=[1, 1], ceil_mode=0,
         count_include_pad=0),
    dict(x=(2, 3, 16), kernel_shape=[4], strides=[3], pads=[0, 2], ceil_mode=1,
         count_include_pad=1),
    dict(x=(1, 2, 7, 9), kernel_shape=[3, 2], strides=[2, 2], pads=[1, 0, 1, 1], ceil_mode=1,
         count_include_pad=0),
])
def test_average_pool_equals_jax(tmp_path, case):
    """AveragePool's window sums on the device against XLA's
    ``reduce_window``: explicit pads counted or not, the ceil-mode
    extension never."""
    g = GraphBuilder()
    y = g.add("AveragePool", ["x"], **{k: v for k, v in case.items() if k != "x"})
    path = g.save(str(tmp_path / "pool.onnx"), ["x"], [y])
    xv = np.random.default_rng(1).standard_normal(case["x"]).astype(np.float32)
    _same_outputs(load_onnx(path), {"x": xv}, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    return {"tokenizer": build_tokenizer_onnx(d / "st.onnx", np.random.default_rng(0), t_in=T_IN),
            "campplus": build_campplus_onnx(d / "cam.onnx", CAM, np.random.default_rng(2),
                                            t_in=CAM_FRAMES),
            "unconvertible": build_unconvertible_tokenizer(d / "u.onnx",
                                                           np.random.default_rng(3))}


def test_model_graphs_run_whole_as_jax(graphs):
    """The tokenizer graph's codes exactly, CAM++'s x-vector at fp32
    tolerance, from the same inputs."""
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, 16, T_IN)).astype(np.float32)
    _same_outputs(load_onnx(graphs["tokenizer"]), {"mel": mel})
    model = load_onnx(graphs["campplus"])
    fbank = rng.standard_normal((1, CAM_FRAMES, CAM.feat_dim)).astype(np.float32)
    _same_outputs(model, {model["inputs"][0]: fbank}, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("forced", [False, True])
def test_executor_frontend_fns_equal_jax(graphs, monkeypatch, forced):
    """``load_frontend_fns`` on a convertible tokenizer and CAM++ under
    ``COSY2EU_ONNX_EXECUTOR=1``, and on the unconvertible tokenizer without
    it: both packages take the executor and give the same codes and
    x-vectors."""
    if forced:
        monkeypatch.setenv("COSY2EU_ONNX_EXECUTOR", "1")
        st, cam = graphs["tokenizer"], graphs["campplus"]
    else:
        st, cam = graphs["unconvertible"], None
    got_st, got_cam = port_fallback.load_frontend_fns(st, cam, device="cpu")
    want_st, want_cam = jax_fallback.load_frontend_fns(st, cam)
    wav = (np.random.default_rng(6).standard_normal(T_IN * 160) * 0.05).astype(np.float32)
    codes = got_st(wav)
    np.testing.assert_array_equal(codes, want_st(wav))
    # the graph's own codes from the JAX package's mel
    model = load_onnx(st)
    mel = np.asarray(whisper_log_mel(jnp.asarray(wav[None]), n_mels=16))
    np.testing.assert_array_equal(
        codes, jax_exec.run_graph(model, {model["inputs"][0]: mel})[0].reshape(-1))
    if forced:
        a, b = got_cam(wav), want_cam(wav)
        assert a.shape == b.shape == (192,)
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.9999
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
    else:
        assert got_cam is None


def test_strict_mode_reraises(graphs):
    with pytest.raises(Exception):
        port_fallback.load_frontend_fns(graphs["unconvertible"], None, strict=True, device="cpu")
    with pytest.raises(Exception):
        jax_fallback.load_frontend_fns(graphs["unconvertible"], None, strict=True)


def test_executor_tokenizer_rejects_a_long_prompt(graphs):
    fn = port_fallback.make_executor_speech_tokenizer_fn(load_onnx(graphs["unconvertible"]),
                                                          device="cpu")
    with pytest.raises(ValueError, match="30 s"):
        fn(np.zeros(30 * 16000 + 1, np.float32))
