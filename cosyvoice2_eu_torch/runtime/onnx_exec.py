"""ONNX graph executor with the reference's semantics, on the host.

Counterpart of ``cosyvoice2_eu_tpu/runtime/onnx_exec.py``: runs a parsed graph
(``runtime/onnx_import.load_onnx``) with plain numpy semantics, so the
structural conversions (``runtime/onnx_convert.py``) are checked against the
graph's own arithmetic, and so ``runtime/onnx_fallback.py`` can run a graph
of a topology the converter does not know.  Everything is numpy on the host
except the convolutions and the average pools, which run through
``torch.nn.functional`` on ``run_graph``'s ``device`` (the JAX package runs
them through XLA).

It covers the ops torch.onnx.export emits for the speech tokenizer and
CAM++ (conv / attention / layernorm / batchnorm / FSQ / pooling / shape
plumbing) and a few more real exports use.  Prompt extraction runs once a
prompt, so speed is secondary.
"""

from __future__ import annotations

import math

import numpy as np

_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64, 16: np.float32,  # bf16 -> f32 best effort
}


def _onnx_div(a, b):
    """ONNX Div truncates toward zero on integer inputs (C semantics);
    np.divide would silently promote shape arithmetic to float."""
    if np.issubdtype(np.asarray(a).dtype, np.integer) and \
            np.issubdtype(np.asarray(b).dtype, np.integer):
        return (np.asarray(a) / np.asarray(b)).astype(np.asarray(a).dtype)
    return np.divide(a, b)


def _onnx_mod(node):
    def op(a, b):
        if int(node["attrs"].get("fmod", 0)):
            return np.fmod(a, b)
        return np.mod(a, b)

    return op


def _torch(x, device):
    import torch

    return torch.as_tensor(np.array(x), device=device)  # a writable copy


def _conv(node, x, w, b=None, device="cpu"):
    import torch.nn.functional as F

    attrs = node["attrs"]
    nd = x.ndim - 2
    strides = tuple(attrs.get("strides", [1] * nd))
    dilations = tuple(attrs.get("dilations", [1] * nd))
    group = int(attrs.get("group", 1))
    pads = attrs.get("pads", [0] * (2 * nd))
    # F.pad takes (begin, end) pairs from the last axis back
    pad = [int(p) for i in reversed(range(nd)) for p in (pads[i], pads[i + nd])]
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    y = conv(F.pad(_torch(x, device), pad), _torch(w, device), stride=strides,
             dilation=dilations, groups=group)
    y = y.cpu().numpy()
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * nd)
    return y


def _window_sums(x, kernel, strides, device):
    """Sums over VALID windows (the ONNX pads already applied)."""
    import torch.nn.functional as F

    t = _torch(x, device)
    if len(kernel) == 1:  # as a 2-d pool over a unit axis
        t, kernel, strides = t[:, :, None], (1,) + kernel, (1,) + strides
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    s = pool(t, kernel, strides, divisor_override=1)
    return s.reshape(s.shape[:2] + s.shape[3:] if x.ndim == 3 else s.shape).cpu().numpy()


def _avg_pool(node, x, device="cpu"):
    attrs = node["attrs"]
    nd = x.ndim - 2
    kernel = tuple(attrs.get("kernel_shape", [1] * nd))
    strides = tuple(attrs.get("strides", kernel))
    pads = attrs.get("pads", [0] * (2 * nd))
    ceil_mode = bool(attrs.get("ceil_mode", 0))
    count_include_pad = bool(attrs.get("count_include_pad", 0))

    pad_cfg = [(0, 0), (0, 0)] + [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    xp = np.pad(x, pad_cfg)
    # divisor counts: explicit pads count iff count_include_pad; the ceil-mode
    # extension never counts (torch semantics)
    ones = np.pad(
        np.ones_like(x), pad_cfg, constant_values=1.0 if count_include_pad else 0.0
    )
    if ceil_mode:
        extra = []
        for i in range(nd):
            t = xp.shape[2 + i]
            out = math.ceil(max(t - kernel[i], 0) / strides[i]) + 1
            need = (out - 1) * strides[i] + kernel[i] - t
            extra.append((0, max(need, 0)))
        xp = np.pad(xp, [(0, 0), (0, 0)] + extra)
        ones = np.pad(ones, [(0, 0), (0, 0)] + extra)
    sums = _window_sums(xp, kernel, strides, device)
    counts = _window_sums(ones, kernel, strides, device)
    return sums / np.maximum(counts, 1.0)


def _gemm(node, a, b, c=None):
    attrs = node["attrs"]
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = attrs.get("alpha", 1.0) * (a @ b)
    if c is not None:
        y = y + attrs.get("beta", 1.0) * c
    return y


def _layer_norm(node, x, scale, bias=None):
    axis = int(node["attrs"].get("axis", -1))
    eps = float(node["attrs"].get("epsilon", 1e-5))
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = x.mean(axis=axes, keepdims=True)
    var = x.var(axis=axes, keepdims=True)
    y = (x - mean) / np.sqrt(var + eps) * scale
    return y + bias if bias is not None else y


def _batch_norm(node, x, scale, bias, mean, var):
    eps = float(node["attrs"].get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    w = scale / np.sqrt(var + eps)
    return x * w.reshape(shape) + (bias - mean * w).reshape(shape)


def _softmax(node, x):
    axis = int(node["attrs"].get("axis", -1))
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def _reduce(fn):
    def op(node, x, axes=None):
        if axes is None:
            axes = node["attrs"].get("axes")
        if axes is not None and not isinstance(axes, (list, tuple, np.ndarray)):
            axes = [axes]
        keep = bool(node["attrs"].get("keepdims", 1))
        ax = tuple(int(a) for a in np.asarray(axes).ravel()) if axes is not None else None
        if ax is not None and len(ax) == 0:
            # empty axes: reduce all unless noop_with_empty_axes
            if node["attrs"].get("noop_with_empty_axes", 0):
                return x
            ax = None
        return fn(x, axis=ax, keepdims=keep)

    return op


def _slice(node, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset-9 attribute style
        starts = node["attrs"]["starts"]
        ends = node["attrs"]["ends"]
        axes = node["attrs"].get("axes")
    starts = np.asarray(starts).ravel()
    ends = np.asarray(ends).ravel()
    axes = (
        np.asarray(axes).ravel() if axes is not None else np.arange(len(starts))
    )
    steps = np.asarray(steps).ravel() if steps is not None else np.ones(len(starts), np.int64)
    sl = [slice(None)] * x.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % x.ndim
        sl[a] = slice(int(s), None if int(e) >= np.iinfo(np.int32).max else int(e), int(st))
    return x[tuple(sl)]


def _pad(node, x, pads=None, value=None):
    if pads is None:
        pads = node["attrs"]["pads"]
    pads = np.asarray(pads).ravel()
    nd = x.ndim
    cfg = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    mode = node["attrs"].get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode == "constant":
        cval = float(value) if value is not None else 0.0
        return np.pad(x, cfg, constant_values=cval)
    return np.pad(x, cfg, mode={"reflect": "reflect", "edge": "edge"}[mode])


def _axes_arg(node, axes, ndim_out: int):
    """Normalize Squeeze/Unsqueeze axes (negatives are output-relative)."""
    if axes is None:
        axes = node["attrs"].get("axes")
    if axes is None:
        return None
    return tuple(int(a) % ndim_out for a in np.asarray(axes).ravel())


def _expand(node, x, shape):
    target = tuple(int(s) for s in np.asarray(shape).ravel())
    out_shape = np.broadcast_shapes(x.shape, target)
    return np.broadcast_to(x, out_shape)


def _split(node, x, split=None):
    axis = int(node["attrs"].get("axis", 0))
    if split is None:
        split = node["attrs"].get("split")
    if split is None:
        n = int(node["attrs"].get("num_outputs", len(node["output"])))
        size = x.shape[axis] // n
        split = [size] * n
    split = [int(s) for s in np.asarray(split).ravel()]
    idx = np.cumsum(split)[:-1]
    return np.split(x, idx, axis=axis)


_BINARY = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply, "Div": _onnx_div,
    "Pow": np.power, "Min": np.minimum, "Max": np.maximum,
    "Equal": np.equal, "Less": np.less, "Greater": np.greater,
    "LessOrEqual": np.less_equal, "GreaterOrEqual": np.greater_equal,
    "And": np.logical_and, "Or": np.logical_or, "Xor": np.logical_xor,
}
_UNARY = {
    "Sqrt": np.sqrt, "Neg": np.negative, "Tanh": np.tanh, "Exp": np.exp,
    "Log": np.log, "Abs": np.abs, "Floor": np.floor, "Ceil": np.ceil,
    "Round": np.round, "Not": np.logical_not,
    "Sin": np.sin, "Cos": np.cos, "Sign": np.sign,
    "Reciprocal": lambda x: 1.0 / x,
    "Softplus": lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0),
    "Relu": lambda x: np.maximum(x, 0),
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "Erf": None,  # filled below (vectorized math.erf)
    "Identity": lambda x: x,
}
_UNARY["Erf"] = np.vectorize(math.erf, otypes=[np.float32])


def run_graph(model: dict, feeds: dict, outputs=None, device="cpu") -> list:
    """Execute a parsed ONNX graph; returns the requested output arrays
    (numpy).  Convolutions and average pools run on ``device``."""
    env: dict[str, np.ndarray] = {}
    env.update(model["initializers"])
    for k, v in feeds.items():
        env[k] = np.asarray(v)

    for node in model["nodes"]:
        op = node["op_type"]
        args = [env[i] if i else None for i in node["input"]]
        a = args[0] if args else None
        if op in _BINARY:
            out = _BINARY[op](args[0], args[1])
        elif op in _UNARY:
            out = _UNARY[op](a)
            if op == "Erf":
                out = out.astype(args[0].dtype)
        elif op == "Conv":
            out = _conv(node, *args, device=device)
        elif op == "Gemm":
            out = _gemm(node, *args)
        elif op == "MatMul":
            out = args[0] @ args[1]
        elif op == "Einsum":
            eq = node["attrs"]["equation"]
            out = np.einsum(eq.decode() if isinstance(eq, bytes) else eq, *args)
        elif op == "Softmax":
            out = _softmax(node, a)
        elif op == "LayerNormalization":
            out = _layer_norm(node, *args)
        elif op == "BatchNormalization":
            out = _batch_norm(node, *args)
        elif op == "Gelu":
            approx = node["attrs"].get("approximate", b"none")
            if (approx.decode() if isinstance(approx, bytes) else approx) == "tanh":
                out = 0.5 * a * (1 + np.tanh(0.7978845608 * (a + 0.044715 * a**3)))
            else:
                out = a * 0.5 * (1 + _UNARY["Erf"](a / np.sqrt(2)).astype(a.dtype))
        elif op == "AveragePool":
            out = _avg_pool(node, a, device=device)
        elif op == "GlobalAveragePool":
            out = a.mean(axis=tuple(range(2, a.ndim)), keepdims=True)
        elif op == "ReduceMean":
            out = _reduce(np.mean)(node, *args)
        elif op == "ReduceSum":
            out = _reduce(np.sum)(node, *args)
        elif op == "ReduceMax":
            out = _reduce(np.max)(node, *args)
        elif op == "ReduceMin":
            out = _reduce(np.min)(node, *args)
        elif op == "Mod":
            out = _onnx_mod(node)(args[0], args[1])
        elif op == "LeakyRelu":
            alpha = float(node["attrs"].get("alpha", 0.01))
            out = np.where(a > 0, a, alpha * a).astype(a.dtype)
        elif op == "Elu":
            alpha = float(node["attrs"].get("alpha", 1.0))
            out = np.where(a > 0, a, alpha * (np.exp(np.minimum(a, 0)) - 1)).astype(a.dtype)
        elif op == "HardSigmoid":
            alpha = float(node["attrs"].get("alpha", 0.2))
            beta = float(node["attrs"].get("beta", 0.5))
            out = np.clip(alpha * a + beta, 0, 1).astype(a.dtype)
        elif op == "HardSwish":
            out = (a * np.clip(a / 6.0 + 0.5, 0, 1)).astype(a.dtype)
        elif op == "PRelu":
            out = np.where(a > 0, a, args[1] * a).astype(a.dtype)
        elif op == "ArgMax":
            axis = int(node["attrs"].get("axis", 0))
            out = np.argmax(a, axis=axis)
            if node["attrs"].get("keepdims", 1):
                out = np.expand_dims(out, axis)
        elif op == "ArgMin":
            axis = int(node["attrs"].get("axis", 0))
            out = np.argmin(a, axis=axis)
            if node["attrs"].get("keepdims", 1):
                out = np.expand_dims(out, axis)
        elif op == "LogSoftmax":
            axis = int(node["attrs"].get("axis", -1))
            m = a.max(axis=axis, keepdims=True)
            out = a - m - np.log(np.exp(a - m).sum(axis=axis, keepdims=True))
        elif op == "CumSum":
            axis = int(np.asarray(args[1]).ravel()[0])
            out = np.cumsum(a, axis=axis)
            if node["attrs"].get("reverse", 0) or node["attrs"].get("exclusive", 0):
                raise NotImplementedError("CumSum reverse/exclusive")
        elif op == "ReduceProd":
            out = _reduce(np.prod)(node, *args)
        elif op == "Trilu":
            k = int(np.asarray(args[1]).ravel()[0]) if len(args) > 1 and args[1] is not None else 0
            upper = int(node["attrs"].get("upper", 1))
            out = np.triu(a, k) if upper else np.tril(a, k)
        elif op == "GatherElements":
            axis = int(node["attrs"].get("axis", 0))
            idx = np.asarray(args[1], np.int64)
            idx = np.where(idx < 0, idx + a.shape[axis], idx)
            out = np.take_along_axis(a, idx, axis=axis)
        elif op == "TopK":
            axis = int(node["attrs"].get("axis", -1))
            k = int(np.asarray(args[1]).ravel()[0])
            largest = int(node["attrs"].get("largest", 1))
            order = np.argsort(a, axis=axis)
            if largest:
                order = np.flip(order, axis=axis)
            idx = np.take(order, np.arange(k), axis=axis)
            out = (np.take_along_axis(a, idx, axis=axis), idx.astype(np.int64))
        elif op == "Shape":
            start = int(node["attrs"].get("start", 0))
            end = node["attrs"].get("end")
            shp = a.shape[start : int(end) if end is not None else None]
            out = np.asarray(shp, np.int64)
        elif op == "Reshape":
            shape = [int(s) for s in np.asarray(args[1]).ravel()]
            shape = [a.shape[i] if s == 0 else s for i, s in enumerate(shape)]
            out = a.reshape(shape)
        elif op == "Flatten":
            axis = int(node["attrs"].get("axis", 1))
            out = a.reshape(int(np.prod(a.shape[:axis], initial=1)), -1)
        elif op == "Transpose":
            perm = node["attrs"].get("perm")
            out = a.transpose(perm if perm else None)
        elif op == "Concat":
            out = np.concatenate([x for x in args if x is not None],
                                 axis=int(node["attrs"]["axis"]))
        elif op == "Split":
            out = _split(node, *args)
        elif op == "Slice":
            out = _slice(node, *args)
        elif op == "Squeeze":
            axes = _axes_arg(node, args[1] if len(args) > 1 else None, a.ndim)
            out = np.squeeze(a, axis=axes) if axes else np.squeeze(a)
        elif op == "Unsqueeze":
            raw = args[1] if len(args) > 1 else None
            n_new = len(np.asarray(raw).ravel()) if raw is not None else len(
                np.asarray(node["attrs"]["axes"]).ravel()
            )
            axes = _axes_arg(node, raw, a.ndim + n_new)
            out = a
            for ax in sorted(axes):
                out = np.expand_dims(out, ax)
        elif op == "Gather":
            axis = int(node["attrs"].get("axis", 0))
            idx = np.asarray(args[1], np.int64)
            idx = np.where(idx < 0, idx + a.shape[axis], idx)  # ONNX allows negatives
            out = np.take(a, idx, axis=axis)
        elif op == "Expand":
            out = _expand(node, *args)
        elif op == "Tile":
            out = np.tile(a, [int(r) for r in np.asarray(args[1]).ravel()])
        elif op == "Where":
            out = np.where(args[0], args[1], args[2])
        elif op == "Cast":
            out = a.astype(_ONNX_DTYPES[int(node["attrs"]["to"])])
        elif op == "Clip":
            lo = args[1] if len(args) > 1 and args[1] is not None else node["attrs"].get("min")
            hi = args[2] if len(args) > 2 and args[2] is not None else node["attrs"].get("max")
            out = np.clip(a, lo, hi)
        elif op == "Constant":
            out = node["attrs"].get("value")
            if out is None:
                for k, dt in (("value_float", np.float32), ("value_int", np.int64),
                              ("value_floats", np.float32), ("value_ints", np.int64)):
                    if k in node["attrs"]:
                        out = np.asarray(node["attrs"][k], dt)
                        break
            out = np.asarray(out)
        elif op == "ConstantOfShape":
            val = node["attrs"].get("value", np.zeros(1, np.float32))
            out = np.full([int(s) for s in np.asarray(a).ravel()],
                          np.asarray(val).ravel()[0])
        elif op == "Range":
            s0, s1, s2 = (np.asarray(x).ravel()[0] for x in args[:3])
            out = np.arange(s0, s1, s2)
        elif op == "Pad":
            out = _pad(node, *args)
        elif op == "Dropout":  # inference mode: identity (+ all-true mask)
            out = (a, np.ones(a.shape, np.bool_)) if len(node["output"]) > 1 else a
        else:
            raise NotImplementedError(f"ONNX op {op} (node {node['name']})")

        if isinstance(out, (list, tuple)):
            for name, val in zip(node["output"], out):
                if name:
                    env[name] = np.asarray(val)
        else:
            env[node["output"][0]] = np.asarray(out)

    return [env[o] for o in (outputs or model["outputs"])]
