"""Random weights of a configuration, made on the device from a seed.

The trees have the layout of the port's parameter trees (dense weight
(out, in), conv1d weight (out, in/groups, k), conv_transpose weight
(in, out, k), embedding (num, dim); the names of the port's ``init_*``
functions) and the same distributions (Kaiming-uniform dense and conv
layers, normal embeddings, unit norms).  Both the port and the reference
take their weights from here, so neither takes weights that the other made.

``make(spec_fn, seed, device)`` first lays the tree out as specs, then draws
every leaf of one distribution and bound with one call on a
``torch.Generator`` of the device: a few tens of calls for a whole model.
The leaves are views of those buffers.  One seed gives the same weights.
"""

from __future__ import annotations

import math

import torch

from .layers import tree_leaves, tree_map


class Spec:
    """One leaf to draw: ``kind`` "u" (uniform in [-a, a]), "n" (standard
    normal) or "c" (the constant a)."""

    __slots__ = ("kind", "shape", "a")

    def __init__(self, kind: str, shape, a: float = 0.0):
        self.kind, self.shape, self.a = kind, tuple(int(s) for s in shape), float(a)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def make(tree, seed: int, device, stream: int = 0) -> dict:
    """The tensors of a tree of ``Spec`` leaves, drawn from ``seed`` (and
    ``stream``, which gives another tree's weights their own draws)."""
    specs = tree_leaves(tree)
    groups: dict = {}
    for i, s in enumerate(specs):
        groups.setdefault((s.kind, s.a), []).append(i)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2**63))
    out: list = [None] * len(specs)
    for (kind, a), idx in sorted(groups.items()):
        n = sum(specs[i].numel for i in idx)
        if kind == "u":
            buf = torch.empty(n, device=device).uniform_(-a, a, generator=gen)
        elif kind == "n":
            buf = torch.randn(n, generator=gen, device=device)
        else:
            buf = torch.full((n,), a, device=device)
        off = 0
        for i in idx:
            out[i] = buf[off:off + specs[i].numel].view(specs[i].shape)
            off += specs[i].numel
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def dense(i: int, o: int, bias: bool = True) -> dict:
    p = {"weight": Spec("u", (o, i), math.sqrt(1.0 / i))}
    if bias:
        p["bias"] = Spec("u", (o,), math.sqrt(1.0 / i))
    return p


def conv1d(i: int, o: int, k: int, groups: int = 1) -> dict:
    fan_in = (i // groups) * k
    return {"weight": Spec("u", (o, i // groups, k), math.sqrt(1.0 / fan_in)),
            "bias": Spec("u", (o,), math.sqrt(1.0 / fan_in))}


def conv_transpose1d(i: int, o: int, k: int) -> dict:
    fan_in = o * k
    return {"weight": Spec("u", (i, o, k), math.sqrt(1.0 / fan_in)),
            "bias": Spec("u", (o,), math.sqrt(1.0 / fan_in))}


def layer_norm(d: int) -> dict:
    return {"weight": Spec("c", (d,), 1.0), "bias": Spec("c", (d,), 0.0)}


def rms_norm(d: int) -> dict:
    return {"weight": Spec("c", (d,), 1.0)}


def embedding(num: int, dim: int) -> dict:
    return {"weight": Spec("n", (num, dim))}


# ---------------------------------------------------------------------------
# the speech LM (Qwen2 / Qwen3 backbone and the CosyVoice2 speech head)
# ---------------------------------------------------------------------------

def backbone(c) -> dict:
    h, q_dim, kv_dim = c.hidden_size, c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    layers = []
    for _ in range(c.num_layers):
        layer = {
            "input_layernorm": rms_norm(h),
            "q_proj": dense(h, q_dim, c.attention_bias),
            "k_proj": dense(h, kv_dim, c.attention_bias),
            "v_proj": dense(h, kv_dim, c.attention_bias),
            "o_proj": dense(q_dim, h, False),
            "post_attention_layernorm": rms_norm(h),
            "gate_proj": dense(h, c.intermediate_size, False),
            "up_proj": dense(h, c.intermediate_size, False),
            "down_proj": dense(c.intermediate_size, h, False),
        }
        if c.use_qk_norm:
            layer["q_norm"] = rms_norm(c.head_dim)
            layer["k_norm"] = rms_norm(c.head_dim)
        layers.append(layer)
    return {"embed_tokens": embedding(c.vocab_size, h), "layers": layers, "norm": rms_norm(h)}


def lm(c) -> dict:
    h, full_vocab = c.backbone.hidden_size, c.speech_token_size + 3
    return {"backbone": backbone(c.backbone), "llm_embedding": embedding(2, h),
            "speech_embedding": embedding(full_vocab, h),
            "llm_decoder": dense(h, full_vocab)}


# ---------------------------------------------------------------------------
# the flow (upsample conformer and causal U-Net estimator)
# ---------------------------------------------------------------------------

def _rel_attention(heads: int, d: int) -> dict:
    d_k = d // heads
    bound = math.sqrt(6.0 / (heads + d_k) / 2)
    return {"linear_q": dense(d, d), "linear_k": dense(d, d), "linear_v": dense(d, d),
            "linear_out": dense(d, d), "linear_pos": dense(d, d, False),
            "pos_bias_u": Spec("u", (heads, d_k), bound),
            "pos_bias_v": Spec("u", (heads, d_k), bound)}


def _conformer_layer(c) -> dict:
    d = c.output_size
    return {"self_attn": _rel_attention(c.attention_heads, d),
            "ffn_w1": dense(d, c.linear_units), "ffn_w2": dense(c.linear_units, d),
            "norm_mha": layer_norm(d), "norm_ff": layer_norm(d)}


def encoder(c) -> dict:
    d = c.output_size
    return {
        "embed": {"linear": dense(c.input_size, d), "norm": layer_norm(d)},
        "pre_lookahead": {"conv1": conv1d(d, d, c.pre_lookahead_len + 1),
                          "conv2": conv1d(d, d, 3)},
        "encoders": [_conformer_layer(c) for _ in range(c.num_blocks)],
        "up_layer": conv1d(d, d, c.upsample_stride * 2 + 1),
        "up_embed": {"linear": dense(c.input_size, d), "norm": layer_norm(d)},
        "up_encoders": [_conformer_layer(c) for _ in range(c.num_up_blocks)],
        "after_norm": layer_norm(d),
    }


def _causal_block(i: int, o: int) -> dict:
    return {"conv": conv1d(i, o, 3), "norm": layer_norm(o)}


def _transformer_block(dim: int, heads: int, head_dim: int) -> dict:
    inner = heads * head_dim
    return {"norm1": layer_norm(dim), "to_q": dense(dim, inner, False),
            "to_k": dense(dim, inner, False), "to_v": dense(dim, inner, False),
            "to_out": dense(inner, dim), "norm3": layer_norm(dim),
            "ff_in": dense(dim, 4 * dim), "ff_out": dense(4 * dim, dim)}


def estimator(c) -> dict:
    ch = c.channels[0]
    time_dim = ch * 4

    def stage(dim_in, dim_out, with_conv):
        s = {"resnet": {"block1": _causal_block(dim_in, dim_out),
                        "block2": _causal_block(dim_out, dim_out),
                        "mlp": dense(time_dim, dim_out),
                        "res_conv": conv1d(dim_in, dim_out, 1)},
             "transformer": [_transformer_block(dim_out, c.num_heads, c.attention_head_dim)
                             for _ in range(c.n_blocks)]}
        if with_conv:
            s["conv"] = conv1d(dim_out, dim_out, 3)
        return s

    return {
        "time_mlp": {"linear_1": dense(c.in_channels, time_dim),
                     "linear_2": dense(time_dim, time_dim)},
        "down": stage(c.in_channels, ch, True),
        "mid": [stage(ch, ch, False) for _ in range(c.num_mid_blocks)],
        "up": stage(ch * 2, ch, True),
        "final_block": _causal_block(ch, ch),
        "final_proj": conv1d(ch, c.out_channels, 1),
    }


def flow(c) -> dict:
    """The flow's tree; its fixed inference noise ``rand_noise`` is drawn
    from the seed too."""
    return {
        "input_embedding": embedding(c.vocab_size, c.input_size),
        "spk_embed_affine_layer": dense(c.spk_embed_dim, c.output_size),
        "encoder": encoder(c.encoder),
        "encoder_proj": dense(c.encoder.output_size, c.output_size),
        "estimator": estimator(c.estimator),
        "rand_noise": Spec("n", (1, c.output_size, c.cfm.rand_noise_frames)),
    }


# ---------------------------------------------------------------------------
# the vocoder (HiFT)
# ---------------------------------------------------------------------------

def _resblock(ch: int, k: int, dilations) -> dict:
    n = len(dilations)
    return {"convs1": [conv1d(ch, ch, k) for _ in range(n)],
            "convs2": [conv1d(ch, ch, k) for _ in range(n)],
            "alpha1": [Spec("c", (ch,), 1.0) for _ in range(n)],
            "alpha2": [Spec("c", (ch,), 1.0) for _ in range(n)]}


def hift(c) -> dict:
    n_ups, base, stft_ch = len(c.upsample_rates), c.base_channels, c.istft_n_fft + 2
    downs = [1]
    for r in reversed(c.upsample_rates[1:]):
        downs.append(downs[-1] * r)
    downs = downs[::-1]  # the cumulative source downsampling of each stage
    fp = c.f0_predictor
    convs, ch_in = [], fp.in_channels
    for _ in range(fp.num_layers):
        convs.append(conv1d(ch_in, fp.cond_channels, fp.kernel_size))
        ch_in = fp.cond_channels
    ups = [conv_transpose1d(base // 2**i, base // 2 ** (i + 1), k)
           for i, k in enumerate(c.upsample_kernel_sizes)]
    source_downs, source_resblocks = [], []
    for i, (u, k, d) in enumerate(zip(downs, c.source_resblock_kernel_sizes,
                                      c.source_resblock_dilation_sizes)):
        ch = base // 2 ** (i + 1)
        source_downs.append(conv1d(stft_ch, ch, 1 if u == 1 else int(u) * 2))
        source_resblocks.append(_resblock(ch, k, d))
    resblocks = [_resblock(base // 2 ** (i + 1), k, d) for i in range(n_ups)
                 for k, d in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)]
    return {
        "f0_predictor": {"convs": convs, "classifier": dense(fp.cond_channels, fp.num_class)},
        "m_source": {"l_linear": dense(c.nb_harmonics + 1, 1)},
        "conv_pre": conv1d(c.in_channels, base, 7),
        "ups": ups,
        "source_downs": source_downs,
        "source_resblocks": source_resblocks,
        "resblocks": resblocks,
        "conv_post": conv1d(base // 2**n_ups, stft_ch, 7),
    }


def tts(c) -> dict:
    """{"llm", "flow", "hift"}: the spec tree of ``load(params=...)``."""
    return {"llm": lm(c.llm), "flow": flow(c.flow), "hift": hift(c.hift)}


def make_tts(c, seed: int, device) -> dict:
    """The weights ``load(params=...)`` takes, each model from buffers of
    its own (so that one kept model holds no other's)."""
    return {k: make(v, seed, device, stream=i) for i, (k, v) in enumerate(tts(c).items())}
