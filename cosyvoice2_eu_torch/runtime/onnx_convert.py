"""ONNX graph -> parameter trees for the two frontend binaries, in the port.

Counterpart of ``cosyvoice2_eu_tpu/runtime/onnx_convert.py``.  The reference
consumes ``speech_tokenizer_v2.onnx`` and ``campplus.onnx`` through
onnxruntime sessions (cosy_repo/cosyvoice/cli/frontend.py:262-283,
tools/extract_speech_token.py:26-40, tools/extract_embedding.py:24-35).
This module maps those graphs onto ``models/speech_tokenizer.py`` and
``models/campplus.py``, as trees of float32 numpy arrays (the factories in
``frontend/frontend.py`` move them to the device).

Conversion is STRUCTURAL, not name-based: torch.onnx.export mangles
initializer names (``onnx::MatMul_123``) and transposes Linear weights, so we
walk the node list in topological order (ONNX requires topo order) and assign
parameters by dataflow position — Conv stride/dilation from node attributes,
MatMul-vs-Gemm weight orientation, LayerNorm scale/bias from (possibly
decomposed) LN patterns.  Every assignment shape-checks against the expected
tree; mismatches raise with the position and shapes so a drifted
architecture is reconciled, not silently mis-mapped.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# graph utilities
# ---------------------------------------------------------------------------

def _producer_map(nodes):
    return {out: n for n in nodes for out in n["output"] if out}


def _consumer_map(nodes):
    out = {}
    for n in nodes:
        for i in n["input"]:
            if i:
                out.setdefault(i, []).append(n)
    return out


_TRANSPARENT_OPS = ("Identity", "Dropout")
_FLOAT_ONNX_TYPES = (1, 10, 11, 16)  # f32, f16, f64, bf16

# ONNX TensorProto dtype enum -> numpy-style kind character
_ONNX_TYPE_KIND = {
    1: "f", 10: "f", 11: "f", 16: "f",               # floats
    2: "u", 4: "u", 12: "u", 13: "u",                # uints
    3: "i", 5: "i", 6: "i", 7: "i",                  # ints
    9: "b",                                          # bool
}

# ops whose output dtype equals their first input's dtype (sufficient for
# deciding Cast transparency; anything not listed propagates "unknown")
_DTYPE_PRESERVING = frozenset(
    "Add Sub Mul Div Pow Sqrt Exp Log Neg Abs Erf Tanh Sigmoid Relu Elu Gelu "
    "LeakyRelu Softplus Softmax LogSoftmax MatMul Gemm Conv ConvTranspose "
    "Transpose Reshape Flatten Squeeze Unsqueeze Expand Concat Slice Split "
    "Gather GatherElements Pad Tile Identity Dropout ReduceMean ReduceSum "
    "ReduceMax ReduceMin Clip Min Max Mean Sum LayerNormalization "
    "InstanceNormalization BatchNormalization AveragePool MaxPool "
    "GlobalAveragePool Resize CumSum Einsum Mod Sin Cos Round Floor Ceil "
    "Sign Reciprocal HardSigmoid HardSwish Selu Celu PRelu Softsign Atan "
    "Asin Acos Sinh Cosh Atanh Asinh Acosh ReduceProd ReduceL1 ReduceL2 "
    "ReduceLogSum ReduceLogSumExp GatherND ScatterND DepthToSpace "
    "SpaceToDepth Trilu ReverseSequence".split()
)
_INT_OUT_OPS = frozenset("Shape Size ArgMax ArgMin NonZero".split())
_BOOL_OUT_OPS = frozenset(
    "Equal Greater Less GreaterOrEqual LessOrEqual Not And Or Xor IsNaN IsInf".split()
)


def _infer_dtype_kinds(model: dict) -> dict:
    """One forward pass of conservative dtype-kind inference ('f'/'i'/'u'/'b'
    or absent = unknown) over the topologically ordered node list.  Graph
    inputs are unknown (the wire format carries no dtype here), so a Cast fed
    directly by a graph input is kept rather than spliced."""
    kinds: dict[str, str] = {
        name: arr.dtype.kind for name, arr in model["initializers"].items()
    }
    for name, et in model.get("input_types", {}).items():
        k = _ONNX_TYPE_KIND.get(int(et))
        if k is not None:
            kinds[name] = k
    for n in model["nodes"]:
        op = n["op_type"]
        out_kind = None
        if op == "Cast":
            out_kind = _ONNX_TYPE_KIND.get(int(n["attrs"].get("to", 0)))
        elif op in _INT_OUT_OPS:
            out_kind = "i"
        elif op in _BOOL_OUT_OPS:
            out_kind = "b"
        elif op == "Where" and len(n["input"]) > 1:
            out_kind = kinds.get(n["input"][1])
        elif op in _DTYPE_PRESERVING and n["input"]:
            out_kind = kinds.get(n["input"][0])
        if out_kind is not None:
            for o in n["output"]:
                if o:
                    kinds[o] = out_kind
    return kinds


def simplify_graph(model: dict) -> dict:
    """Splice out value-preserving plumbing nodes torch exports sprinkle in:
    Identity, inference-mode Dropout, and float->float Cast (a Cast is only
    treated as float->float when the source dtype is provably float via
    forward dtype inference — an int->float Cast must stay, or downstream
    arithmetic would truncate).  Returns a new model dict whose nodes
    reference the spliced-through names directly, so structural pattern
    matching (bias_after, LN fusion) is not broken by an Identity sitting
    between a MatMul and its bias Add.

    Name-rewrite only — never changes arithmetic.
    """
    dtype_kinds = _infer_dtype_kinds(model)
    # names whose value is actually read downstream (consumers + graph outs):
    # a Dropout is only value-preserving on output[0]; if its mask output is
    # consumed, splicing would hand the consumer activations instead of a
    # bool mask, so such nodes are kept as-is.
    used: set = set(model["outputs"])
    for n in model["nodes"]:
        used.update(i for i in n["input"] if i)

    alias: dict[str, str] = {}
    kept = []
    for n in model["nodes"]:
        op = n["op_type"]
        transparent = op in _TRANSPARENT_OPS or (
            op == "Cast"
            and int(n["attrs"].get("to", 0)) in _FLOAT_ONNX_TYPES
            and bool(n["input"])
            and dtype_kinds.get(n["input"][0]) == "f"
        )
        if transparent and any(o in used for o in n["output"][1:]):
            transparent = False  # secondary output (e.g. Dropout mask) is read
        # resolve already-aliased inputs first
        inputs = [alias.get(i, i) for i in n["input"]]
        if transparent and inputs and n["output"]:
            src = inputs[0]
            if n["output"][0]:
                alias[n["output"][0]] = src
            continue
        kept.append({**n, "input": inputs})
    outputs = [alias.get(o, o) for o in model["outputs"]]
    return {**model, "nodes": kept, "outputs": outputs}


def fuse_layer_norms(model: dict) -> list:
    """Return a node list with decomposed LayerNorms (opset < 17) re-fused.

    Matches torch's decomposition anchored at Div:
      rm1 = ReduceMean(x); sub = Sub(x, rm1); pow = Pow(sub, 2);
      rm2 = ReduceMean(pow); add = Add(rm2, eps); sqrt = Sqrt(add);
      div = Div(sub, sqrt); mul = Mul(div, scale); out = Add(mul, bias)
    and replaces the chain with a synthetic LayerNormalization node.
    """
    nodes = model["nodes"]
    init = model["initializers"]
    producer = _producer_map(nodes)
    consumers = _consumer_map(nodes)

    def prod(name, op):
        n = producer.get(name)
        return n if n is not None and n["op_type"] == op else None

    replaced: dict[int, dict] = {}  # id(first node of chain) -> fused node
    dead: set[int] = set()
    for div in nodes:
        if div["op_type"] != "Div":
            continue
        sub = prod(div["input"][0], "Sub")
        sqrt = prod(div["input"][1], "Sqrt")
        if sub is None or sqrt is None:
            continue
        rm1 = prod(sub["input"][1], "ReduceMean")
        if rm1 is None or rm1["input"][0] != sub["input"][0]:
            continue
        add_eps = prod(sqrt["input"][0], "Add")
        if add_eps is None:
            continue
        rm2 = prod(add_eps["input"][0], "ReduceMean")
        eps_src = add_eps["input"][1]
        if rm2 is None:
            rm2, eps_src = prod(add_eps["input"][1], "ReduceMean"), add_eps["input"][0]
        if rm2 is None:
            continue
        pw = prod(rm2["input"][0], "Pow")
        if pw is None or pw["input"][0] != sub["output"][0]:
            continue
        # epsilon constant
        if eps_src in init:
            eps = float(np.asarray(init[eps_src]).ravel()[0])
        else:
            cnode = prod(eps_src, "Constant")
            eps = float(np.asarray(cnode["attrs"]["value"]).ravel()[0]) if cnode else 1e-5
        # scale/bias consumers
        muls = [c for c in consumers.get(div["output"][0], []) if c["op_type"] == "Mul"]
        if not muls:
            continue
        mul = muls[0]
        scale_name = mul["input"][1] if mul["input"][0] == div["output"][0] else mul["input"][0]
        adds = [c for c in consumers.get(mul["output"][0], []) if c["op_type"] == "Add"]
        if not adds:
            continue
        add_b = adds[0]
        bias_name = (
            add_b["input"][1] if add_b["input"][0] == mul["output"][0] else add_b["input"][0]
        )
        fused = {
            "op_type": "LayerNormalization",
            "input": [sub["input"][0], scale_name, bias_name],
            "output": [add_b["output"][0]],
            "name": f"fused_ln_{div['name']}",
            "attrs": {"axis": -1, "epsilon": eps},
        }
        chain = [rm1, sub, pw, rm2, add_eps, sqrt, div, mul, add_b]
        replaced[id(rm1)] = fused
        dead.update(id(n) for n in chain)

    out = []
    for n in nodes:
        if id(n) in replaced:
            out.append(replaced[id(n)])
        elif id(n) not in dead:
            out.append(n)
    return out


class _Walk:
    """Positional cursor over typed node streams in topological order."""

    def __init__(self, model: dict, nodes=None):
        self.nodes = nodes if nodes is not None else model["nodes"]
        self.init = model["initializers"]
        self.consumers = _consumer_map(self.nodes)
        self.producer = _producer_map(self.nodes)

    def stream(self, *op_types):
        return [n for n in self.nodes if n["op_type"] in op_types]

    def weight(self, node, idx=1):
        name = node["input"][idx] if idx < len(node["input"]) else None
        if name is None or name not in self.init:
            return None
        return np.asarray(self.init[name], np.float32)

    def linear_weight(self, node):
        """(out, in) weight for a MatMul/Gemm node, fixing orientation."""
        w = self.weight(node)
        if w is None:
            return None
        if node["op_type"] == "MatMul":
            return w.T.copy()  # MatMul stores (in, out)
        if node["attrs"].get("transB", 0):
            return w
        return w.T.copy()

    def bias_after(self, node):
        """1-D initializer Add immediately consuming `node`'s output."""
        for c in self.consumers.get(node["output"][0], []):
            if c["op_type"] == "Add":
                for i in c["input"]:
                    if i in self.init and np.asarray(self.init[i]).ndim == 1:
                        return np.asarray(self.init[i], np.float32)
        # Gemm carries its own bias as input 2
        if node["op_type"] == "Gemm" and len(node["input"]) > 2:
            return self.weight(node, 2)
        return None


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _check(name: str, got: np.ndarray, want_shape) -> np.ndarray:
    if tuple(got.shape) != tuple(want_shape):
        raise ValueError(f"{name}: onnx shape {tuple(got.shape)} != expected {tuple(want_shape)}")
    return got


# ---------------------------------------------------------------------------
# speech tokenizer (S3Tokenizer v2 topology)
# ---------------------------------------------------------------------------

def convert_speech_tokenizer(model: dict):
    """Parsed ONNX graph -> (params tree, SpeechTokenizerConfig).

    Reads conv strides from the graph, infers d_model / layer count /
    ffn width / head count / FSQ dim from the dataflow.
    """
    from cosyvoice2_eu_torch.models.speech_tokenizer import SpeechTokenizerConfig

    model = simplify_graph(model)
    nodes = fuse_layer_norms(model)
    g = _Walk(model, nodes)

    convs = [n for n in g.stream("Conv") if g.weight(n) is not None]
    if len(convs) < 2:
        raise ValueError(f"expected >=2 Conv nodes, found {len(convs)}")
    conv_ws = [g.weight(n) for n in convs]
    n_mels = conv_ws[0].shape[1]
    d_model = conv_ws[-1].shape[0]
    strides = tuple(int(n["attrs"].get("strides", [1])[0]) for n in convs)

    lns = g.stream("LayerNormalization")
    mms = [n for n in g.stream("MatMul", "Gemm") if g.linear_weight(n) is not None]
    # per block: q, k, v, out, ff1, ff2 (trace order); final = project_down.
    # Torch can also export attention with a FUSED in_proj — one (3d, d)
    # matmul — giving qkv, out, ff1, ff2 = 4 per block.  Detect by shape.
    fused_qkv = False
    if len(mms) > 1 and (len(mms) - 1) % 6 == 0 \
            and g.linear_weight(mms[0]).shape[0] == d_model:
        num_layers = (len(mms) - 1) // 6
    elif len(mms) > 1 and (len(mms) - 1) % 4 == 0 \
            and g.linear_weight(mms[0]).shape[0] == 3 * d_model:
        fused_qkv = True
        num_layers = (len(mms) - 1) // 4
    else:
        raise ValueError(
            f"unexpected MatMul/Gemm count {len(mms)} (want 6n+1 separate-QKV "
            f"or 4n+1 fused-QKV for d_model={d_model})"
        )
    if len(lns) != 2 * num_layers:
        raise ValueError(f"LayerNorm count {len(lns)} != 2*{num_layers}")

    ffn_dim = g.linear_weight(mms[2 if fused_qkv else 4]).shape[0]
    fsq_w = g.linear_weight(mms[-1])
    fsq_dim = fsq_w.shape[0]

    # head count from the first post-q Reshape constant (B, T, H, hd)
    num_heads = None
    for n in g.stream("Reshape"):
        shp = g.weight(n)
        if shp is not None and shp.ndim == 1 and len(shp) == 4 and 0 < shp[2] < d_model:
            num_heads = int(shp[2])
            break
    if num_heads is None:
        num_heads = max(d_model // 64, 1)

    cfg = SpeechTokenizerConfig(
        n_mels=n_mels, d_model=d_model, num_heads=num_heads, num_layers=num_layers,
        ffn_dim=ffn_dim, conv_strides=strides, fsq_dim=fsq_dim,
    )

    def lin(node, shape, bias=True):
        p = {"weight": _f32(_check("linear", g.linear_weight(node), shape))}
        b = g.bias_after(node)
        if bias and b is not None:
            p["bias"] = _f32(_check("bias", b, (shape[0],)))
        return p

    d = d_model
    params = {}
    for i, (cn, cw) in enumerate(zip(convs, conv_ws)):
        p = {"weight": _f32(cw)}
        b = g.weight(cn, 2)
        if b is not None:
            p["bias"] = _f32(b)
        params[f"conv{i + 1}"] = p

    def ln_params(node):
        return {
            "weight": _f32(_check("ln.w", g.weight(node, 1), (d,))),
            "bias": _f32(_check("ln.b", g.weight(node, 2), (d,))),
        }

    def qkv_parts(node):
        """Split a fused (3d, d) in_proj into q/k/v param dicts."""
        w = _check("qkv", g.linear_weight(node), (3 * d, d))
        b = g.bias_after(node)
        parts = []
        for i in range(3):
            p = {"weight": _f32(w[i * d : (i + 1) * d])}
            if b is not None:
                p["bias"] = _f32(b[i * d : (i + 1) * d])
            parts.append(p)
        return parts

    layers = []
    for li in range(num_layers):
        if fused_qkv:
            qkv, out, ff1, ff2 = mms[4 * li : 4 * li + 4]
            qp, kp, vp = qkv_parts(qkv)
        else:
            q, k, v, out, ff1, ff2 = mms[6 * li : 6 * li + 6]
            qp = lin(q, (d, d))
            kp = lin(k, (d, d), bias=False)
            vp = lin(v, (d, d))
        layers.append(
            {
                "attn_ln": ln_params(lns[2 * li]),
                "q": qp,
                "k": kp,
                "v": vp,
                "out": lin(out, (d, d)),
                "mlp_ln": ln_params(lns[2 * li + 1]),
                "ff1": lin(ff1, (cfg.ffn_dim, d)),
                "ff2": lin(ff2, (d, cfg.ffn_dim)),
            }
        )
    params["layers"] = layers
    params["project_down"] = lin(mms[-1], (fsq_dim, d))

    # positional table, if the export froze the buffer (else computed on the fly)
    for n in g.stream("Add"):
        for i in n["input"]:
            if i in g.init:
                arr = np.asarray(g.init[i])
                if arr.ndim >= 2 and arr.shape[-1] == d and arr.shape[-2] > 8:
                    params["positional_embedding"] = _f32(
                        arr.reshape(-1, d).astype(np.float32)
                    )
    return params, cfg


# ---------------------------------------------------------------------------
# CAM++ (3D-Speaker topology)
# ---------------------------------------------------------------------------

def convert_campplus(model: dict, cfg=None):
    """Parsed ONNX graph -> (params tree, CAMPPlusConfig).

    CAM++ is a rigid Conv/BatchNorm execution sequence; conversion walks the
    Conv and BatchNormalization node streams in topological order and fills
    the expected tree positionally, shape-checking every assignment.
    """
    import torch

    from cosyvoice2_eu_torch.models.campplus import init_campplus

    model = simplify_graph(model)
    nodes = fuse_layer_norms(model)
    g = _Walk(model, nodes)
    convs = [n for n in g.stream("Conv") if g.weight(n) is not None]
    bns = g.stream("BatchNormalization")

    if cfg is None:
        cfg = _infer_campplus_config(g, convs)

    skeleton = init_campplus(torch.Generator(), cfg)  # shapes only
    ci = iter(convs)
    bi = iter(bns)

    def take_conv(path, want, expect_bias):
        n = next(ci)
        w = _check(f"{path}.weight", g.weight(n), want["weight"].shape)
        p = {"weight": _f32(w)}
        b = g.weight(n, 2)
        if expect_bias:
            if b is None:
                raise ValueError(f"{path}: expected conv bias, none in graph")
            p["bias"] = _f32(_check(f"{path}.bias", b, (w.shape[0],)))
        elif b is not None:
            p["bias"] = _f32(b)  # graph has one; keep it
        return p

    def take_bn(path, want):
        n = next(bi)
        c = want["weight"].shape[0]
        return {
            "weight": _f32(_check(f"{path}.w", g.weight(n, 1), (c,))),
            "bias": _f32(_check(f"{path}.b", g.weight(n, 2), (c,))),
            "mean": _f32(_check(f"{path}.mean", g.weight(n, 3), (c,))),
            "var": _f32(_check(f"{path}.var", g.weight(n, 4), (c,))),
        }

    head_sk = skeleton["head"]
    head = {
        "conv1": take_conv("head.conv1", head_sk["conv1"], False),
        "bn1": take_bn("head.bn1", head_sk["bn1"]),
    }
    for li in range(len(cfg.fcm_blocks)):
        stage = []
        for bi_idx, blk in enumerate(head_sk[f"layer{li + 1}"]):
            p = {
                "conv1": take_conv(f"layer{li+1}.{bi_idx}.conv1", blk["conv1"], False),
                "bn1": take_bn(f"layer{li+1}.{bi_idx}.bn1", blk["bn1"]),
                "conv2": take_conv(f"layer{li+1}.{bi_idx}.conv2", blk["conv2"], False),
                "bn2": take_bn(f"layer{li+1}.{bi_idx}.bn2", blk["bn2"]),
            }
            if "shortcut_conv" in blk:
                p["shortcut_conv"] = take_conv(
                    f"layer{li+1}.{bi_idx}.shortcut", blk["shortcut_conv"], False
                )
                p["shortcut_bn"] = take_bn(f"layer{li+1}.{bi_idx}.sc_bn", blk["shortcut_bn"])
            stage.append(p)
        head[f"layer{li + 1}"] = stage
    head["conv2"] = take_conv("head.conv2", head_sk["conv2"], False)
    head["bn2"] = take_bn("head.bn2", head_sk["bn2"])
    params = {"head": head}

    params["tdnn"] = {
        "linear": take_conv("tdnn.linear", skeleton["tdnn"]["linear"], False),
        "bn": take_bn("tdnn.bn", skeleton["tdnn"]["bn"]),
    }

    blocks, transits = [], []
    for gi, blk_sk in enumerate(skeleton["blocks"]):
        layers = []
        for lj, lsk in enumerate(blk_sk["layers"]):
            tag = f"block{gi+1}.layer{lj+1}"
            layers.append(
                {
                    "bn1": take_bn(f"{tag}.bn1", lsk["bn1"]),
                    "lin1": take_conv(f"{tag}.lin1", lsk["lin1"], False),
                    "bn2": take_bn(f"{tag}.bn2", lsk["bn2"]),
                    "local": take_conv(f"{tag}.local", lsk["local"], False),
                    "gate1": take_conv(f"{tag}.gate1", lsk["gate1"], True),
                    "gate2": take_conv(f"{tag}.gate2", lsk["gate2"], True),
                }
            )
        blocks.append({"layers": layers})
        tsk = skeleton["transits"][gi]
        transits.append(
            {
                "bn": take_bn(f"transit{gi+1}.bn", tsk["bn"]),
                "lin": take_conv(f"transit{gi+1}.lin", tsk["lin"], False),
            }
        )
    params["blocks"] = blocks
    params["transits"] = transits
    params["out_bn"] = take_bn("out_bn", skeleton["out_bn"])
    params["dense"] = {
        "lin": take_conv("dense.lin", skeleton["dense"]["lin"], False),
        "bn": take_bn("dense.bn", skeleton["dense"]["bn"]),
    }

    leftover_c = sum(1 for _ in ci)
    leftover_b = sum(1 for _ in bi)
    if leftover_c or leftover_b:
        raise ValueError(
            f"unconsumed graph params: {leftover_c} convs, {leftover_b} batchnorms "
            f"(config {cfg} does not match the graph)"
        )
    return params, cfg


def _infer_campplus_config(g: _Walk, convs) -> "CAMPPlusConfig":
    """Derive the block structure from the graph (reconciliation step).

    FCM stages come from the 2-D conv stream (a BasicResBlock contributes two
    3x3 convs, plus a 1x1 projection when it opens a stage); dense-TDNN layer
    counts come from the BatchNorm channel sequence, which unambiguously
    separates layer pairs (bn1=growing, bn2=bottleneck) from transit norms.
    """
    from cosyvoice2_eu_torch.models.campplus import CAMPPlusConfig

    ws = [g.weight(n) for n in convs]
    conv2d_idx = [i for i, w in enumerate(ws) if w.ndim == 4]
    conv1d_idx = [i for i, w in enumerate(ws) if w.ndim == 3]
    conv2d = [ws[i] for i in conv2d_idx]
    conv1d = [ws[i] for i in conv1d_idx]
    fcm_channels = conv2d[0].shape[0]

    # stage structure: [conv1] + resblocks + [conv2]; a 1x1 kernel after a
    # 3x3 pair marks a projected (stage-opening) block
    fcm_blocks: list[int] = []
    i = 1
    end = len(conv2d) - 1
    count = 0
    while i < end:
        has_proj = i + 2 < end and conv2d[i + 2].shape[-1] == 1
        if has_proj:
            if count:
                fcm_blocks.append(count)
            count = 1
            i += 3
        else:
            count += 1
            i += 2
    if count:
        fcm_blocks.append(count)

    init_channels = conv1d[0].shape[0]
    stem_in = conv1d[0].shape[1]
    feat_dim = stem_in // fcm_channels * (2 ** (len(fcm_blocks) + 1))
    bn_channels = conv1d[1].shape[0]
    growth = conv1d[2].shape[0]
    embedding = conv1d[-1].shape[0]

    # dense-TDNN layer counts from BN channel sizes after the tdnn stem:
    # per layer (bn1=C+n*growth, bn2=bn_channels); a transit bn breaks pairs
    bn_nodes = g.stream("BatchNormalization")
    bn_ch = [np.asarray(g.weight(n, 1)).shape[0] for n in bn_nodes]
    n_res_bns = len(conv2d) - 2  # one BN per 2-D conv inside resblocks
    seq = bn_ch[2 + n_res_bns + 1 :]  # skip head bn1, block bns, head bn2, tdnn bn
    block_layers: list[int] = []
    channels = init_channels
    pos = 0
    while len(seq) - pos > 2:  # leave out_bn + dense bn
        n = 0
        while (
            pos + 1 < len(seq)
            and seq[pos] == channels + n * growth
            and seq[pos + 1] == bn_channels
        ):
            pos += 2
            n += 1
        if n == 0:
            raise ValueError(
                f"cannot parse dense-TDNN structure at bn channels {seq[pos:pos+4]}"
            )
        block_layers.append(n)
        channels += n * growth
        if pos < len(seq) and seq[pos] == channels:
            pos += 1  # transit bn
        channels //= 2

    # dilations per block from the local (k>1) conv attributes
    local_dils = [
        int(convs[i]["attrs"].get("dilations", [1])[0])
        for i in conv1d_idx
        if ws[i].ndim == 3 and ws[i].shape[2] > 1 and ws[i].shape[0] == growth
    ]
    dilations, seen = [], 0
    kernel = next(
        (ws[i].shape[2] for i in conv1d_idx if ws[i].shape[2] > 1 and ws[i].shape[0] == growth),
        3,
    )
    for nl in block_layers:
        dilations.append(local_dils[seen] if seen < len(local_dils) else 1)
        seen += nl

    return CAMPPlusConfig(
        feat_dim=feat_dim,
        embedding_size=embedding,
        fcm_channels=fcm_channels,
        fcm_blocks=tuple(fcm_blocks),
        init_channels=init_channels,
        growth_rate=growth,
        bn_channels=bn_channels,
        block_layers=tuple(block_layers),
        block_dilations=tuple(dilations),
        kernel_size=int(kernel),
    )
