"""Typed configuration of the PyTorch port.

The port keeps its own copy of the dataclasses it needs from
``cosyvoice2_eu_tpu/config.py``, with identical fields and defaults; the
defaults reproduce the published CosyVoice2-EU model (Qwen2-0.5B LM,
512-wide upsample conformer, 256-channel causal U-Net estimator, HiFT 8/5/3).
A test holds ``config_to_dict`` of both packages equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """Qwen2-0.5B decoder backbone (used via inputs_embeds only)."""

    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True  # unused: CosyVoice reads hidden states only
    use_qk_norm: bool = False
    attention_bias: bool = True


def qwen3_0_6b_config() -> Qwen2Config:
    """Qwen3-0.6B backbone (the reference's ``--backbone hf:Qwen/Qwen3-0.6B``):
    the published ``config.json``'s widths, per-head q/k norms, no attention
    bias."""
    return Qwen2Config(
        vocab_size=151936,
        hidden_size=1024,
        intermediate_size=3072,
        num_layers=28,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        rms_norm_eps=1e-6,
        rope_theta=1_000_000.0,
        use_qk_norm=True,
        attention_bias=False,
    )


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    """A DeepSeek-V3 decoder backbone (``models/deepseek_v3.py``), training
    forward only: MLA without q compression, ``first_k_dense_replace`` dense
    layers, then MoE layers whose sigmoid router scores all
    ``n_routed_experts`` and picks ``num_experts_per_tok`` by score plus a
    frozen correction bias (noaux_tc, one group).  This process holds the
    routed experts ``[held_offset, held_offset + held_experts)`` of each MoE
    layer (expert parallelism) and computes their part of the layer for the
    tokens routed to them, plus the ``n_shared_experts`` shared experts.
    Defaults: Moonlight-16B-A3B's ``config.json``, every expert held;
    ``aux_loss_alpha`` is DeepSeek-V3's sequence-wise balance factor."""

    model_type: str = "deepseek_v3"
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    first_k_dense_replace: int = 1
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    aux_loss_alpha: float = 1e-4
    held_experts: int = 64
    held_offset: int = 0
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50_000.0
    max_position_embeddings: int = 8192

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


BACKBONES = {"deepseek_v3": DeepseekV3Config}  # a backbone dict's ``model_type``; else Qwen2


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Speech-token LM wrapper around the Qwen2 backbone (or a
    ``DeepseekV3Config`` one, for training)."""

    backbone: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)
    speech_token_size: int = 6561  # FSQ vocab = 3**8
    sos_eos: int = 0
    task_id: int = 1
    fill_token: int = 2
    mix_ratio: Tuple[int, int] = (5, 15)
    lsm_weight: float = 0.0
    length_normalized_loss: bool = True
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0
    # static decode capacity (prompt + generated tokens) of the KV cache
    max_seq_len: int = 2048

    @property
    def full_vocab(self) -> int:
        return self.speech_token_size + 3

    @property
    def eos_token(self) -> int:
        return self.speech_token_size


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """Upsample conformer encoder of the flow model."""

    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    upsample_stride: int = 2  # token -> mel ratio
    static_chunk_size: int = 25  # tokens, pre-upsample
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class AsrDecoderConfig:
    """ASR-style attention decoder (the rescoring head, ``models/decoder.py``).

    Reference: cosy_repo/cosyvoice/transformer/decoder.py:33
    TransformerDecoder / :256 BiTransformerDecoder.
    """

    vocab_size: int = 4233
    encoder_output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    r_num_blocks: int = 0  # >0 enables the right-to-left decoder
    input_layer: str = "embed"  # embed | no_pos
    use_output_layer: bool = True
    normalize_before: bool = True
    src_attention: bool = True
    key_bias: bool = True
    activation_type: str = "relu"
    max_len: int = 5000


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Causal U-Net CFM estimator."""

    in_channels: int = 320  # x(80) + mu(80) + spks(80) + cond(80)
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    attention_head_dim: int = 64
    n_blocks: int = 4  # transformer blocks per down/mid/up stage
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"
    static_chunk_size: int = 50  # mel frames = 25 tokens * ratio 2
    num_decoding_left_chunks: int = -1
    time_embed_scale: float = 1000.0


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """Optimal-transport conditional flow matching."""

    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10
    rand_noise_frames: int = 50 * 300


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Flow-matching mel decoder (token -> mel)."""

    input_size: int = 512
    output_size: int = 80  # mel bins
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    only_mask_loss: bool = True
    encoder: ConformerConfig = dataclasses.field(default_factory=ConformerConfig)
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    cfm: CFMConfig = dataclasses.field(default_factory=CFMConfig)


@dataclasses.dataclass(frozen=True)
class F0PredictorConfig:
    """ConvRNNF0Predictor of HiFT."""

    num_class: int = 1
    in_channels: int = 80
    cond_channels: int = 512
    num_layers: int = 5
    kernel_size: int = 3


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    """HiFT vocoder: NSF source + HiFi-GAN MRF + iSTFT head."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_predictor: F0PredictorConfig = dataclasses.field(
        default_factory=F0PredictorConfig
    )

    @property
    def upsample_scale(self) -> int:
        scale = self.istft_hop_len
        for r in self.upsample_rates:
            scale *= r
        return scale  # 8*5*3*4 = 480 samples per mel frame


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel featurizer used for prompt features."""

    n_fft: int = 1920
    num_mels: int = 80
    sampling_rate: int = 24000
    hop_size: int = 480
    win_size: int = 1920
    fmin: float = 0.0
    fmax: Optional[float] = None
    center: bool = False


@dataclasses.dataclass(frozen=True)
class WhisperMelConfig:
    """128-bin whisper-style mel for the speech tokenizer input."""

    n_fft: int = 400
    num_mels: int = 128
    sampling_rate: int = 16000
    hop_size: int = 160
    win_size: int = 400
    fmin: float = 0.0
    fmax: Optional[float] = None
    center: bool = True


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Chunked streaming schedule and vocoder cache sizes."""

    token_hop_len: int = 25
    pre_lookahead_len: int = 3
    mel_cache_len: int = 8
    samples_per_frame: int = 480

    @property
    def source_cache_len(self) -> int:
        return self.mel_cache_len * self.samples_per_frame


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Host-side text/prompt processing knobs."""

    prompt_sr: int = 16000
    target_sr: int = 24000
    max_prompt_seconds: float = 30.0
    split_token_budget: int = 80
    spk_embed_dim: int = 192


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Top-level model graph configuration."""

    sample_rate: int = 24000
    token_frame_rate: int = 25
    token_mel_ratio: int = 2
    chunk_size: int = 25
    llm: LMConfig = dataclasses.field(default_factory=LMConfig)
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    hift: HiFTConfig = dataclasses.field(default_factory=HiFTConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    whisper_mel: WhisperMelConfig = dataclasses.field(default_factory=WhisperMelConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference: conf/cosyvoice2.yaml train_conf)."""

    optim: str = "adamw"
    lr: float = 1e-5
    weight_decay: float = 0.0
    scheduler: str = "constantlr"
    warmup_steps: int = 2500
    # NeMo annealing family knobs (reference utils/scheduler.py:74-718)
    max_steps: int = 100_000
    min_lr: float = 0.0
    constant_steps: int = 0
    sched_d_model: int = 896  # NoamAnnealing normalizer (Qwen2-0.5B hidden)
    max_epoch: int = 30
    grad_clip: float = 5.0
    accum_grad: int = 4
    log_interval: int = 100
    save_per_step: int = 3000
    # GAN training (train_conf_gan)
    gan_lr: float = 2e-4
    # parallelism
    dp_size: int = -1  # -1: all devices data-parallel
    fsdp_size: int = 1  # optimizer/parameter sharding axis (ZeRO-equivalent)


# ---------------------------------------------------------------------------
# the v1 family (CosyVoice-300M): defaults are the published conf/cosyvoice.yaml
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GenericEncoderConfig:
    """The ESPnet-style Transformer/Conformer encoder family (the v1 text
    encoder, speech LM and flow encoder)."""

    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    arch: str = "conformer"  # transformer | conformer
    input_layer: str = "conv2d"  # linear|linear_legacy|embed|conv1d2|conv2d|conv2d6|conv2d8
    pos_enc_layer_type: str = "rel_pos_espnet"
    # abs_pos | rel_pos | rel_pos_espnet | no_pos | abs_pos_whisper | embed_learnable_pe
    selfattention_layer_type: str = "rel_selfattn"  # selfattn | rel_selfattn
    activation_type: str = "swish"  # relu | swish | gelu
    normalize_before: bool = True
    static_chunk_size: int = 0
    use_dynamic_chunk: bool = False
    use_dynamic_left_chunk: bool = False
    key_bias: bool = True
    macaron_style: bool = True  # conformer only
    use_cnn_module: bool = True  # conformer only
    cnn_module_kernel: int = 15
    cnn_module_norm: str = "batch_norm"  # batch_norm | layer_norm
    causal: bool = False  # causal depthwise conv in the CNN module
    vocab_size: int = 0  # for input_layer == "embed"
    max_len: int = 5000  # positional table length
    gradient_checkpointing: bool = False
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class EstimatorV1Config:
    """Non-causal multi-scale U-Net CFM estimator of the v1 flow."""

    in_channels: int = 320  # x(80) + mu(80) + spks(80) + cond(80)
    out_channels: int = 80
    channels: Tuple[int, ...] = (256, 256)
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"
    time_embed_scale: float = 1000.0


@dataclasses.dataclass(frozen=True)
class LengthRegulatorConfig:
    """InterpolateRegulator: linear resample + conv/GroupNorm/Mish stack."""

    channels: int = 80
    sampling_ratios: Tuple[int, ...] = (1, 1, 1, 1)
    groups: int = 1


def _v1_flow_encoder() -> GenericEncoderConfig:
    # plain (non-upsampling) conformer
    return GenericEncoderConfig(
        input_size=512, output_size=512, attention_heads=8, linear_units=2048,
        num_blocks=6, arch="conformer", input_layer="linear",
        pos_enc_layer_type="rel_pos_espnet", selfattention_layer_type="rel_selfattn",
        use_cnn_module=False, macaron_style=False,
    )


@dataclasses.dataclass(frozen=True)
class FlowV1Config:
    """v1 flow (MaskedDiffWithXvec): tokens map 1:1 through the encoder and a
    length regulator stretches them to the mel length (token_mel_ratio 1)."""

    input_size: int = 512
    output_size: int = 80  # mel bins
    spk_embed_dim: int = 192
    vocab_size: int = 4096
    input_frame_rate: int = 50
    only_mask_loss: bool = True
    token_mel_ratio: int = 1
    sample_rate: int = 22050
    mel_hop: int = 256
    encoder: GenericEncoderConfig = dataclasses.field(default_factory=_v1_flow_encoder)
    length_regulator: LengthRegulatorConfig = dataclasses.field(
        default_factory=LengthRegulatorConfig)
    estimator: EstimatorV1Config = dataclasses.field(default_factory=EstimatorV1Config)
    cfm: CFMConfig = dataclasses.field(default_factory=CFMConfig)
    cache_tail_tokens: int = 20  # streaming token overlap pinned in the z/mu cache

    @property
    def cache_tail(self) -> int:
        # 34 frames for the published geometry (20 tokens, 50 Hz, 22.05 kHz / 256)
        return int(self.cache_tail_tokens / self.input_frame_rate
                   * self.sample_rate / self.mel_hop)


def _v1_text_encoder() -> GenericEncoderConfig:
    # static_chunk_size 1: causal
    return GenericEncoderConfig(
        input_size=512, output_size=1024, attention_heads=16, linear_units=4096,
        num_blocks=6, arch="conformer", input_layer="linear",
        pos_enc_layer_type="rel_pos_espnet", selfattention_layer_type="rel_selfattn",
        use_cnn_module=False, macaron_style=False, static_chunk_size=1,
    )


def _v1_llm_encoder() -> GenericEncoderConfig:
    # the decoder-only speech-token LM; relu, the TransformerEncoder default
    return GenericEncoderConfig(
        input_size=1024, output_size=1024, attention_heads=16, linear_units=4096,
        num_blocks=14, arch="transformer", input_layer="linear_legacy",
        pos_enc_layer_type="rel_pos_espnet", selfattention_layer_type="rel_selfattn",
        activation_type="relu", static_chunk_size=1,
    )


@dataclasses.dataclass(frozen=True)
class LMV1Config:
    """v1 TransformerLM: conformer text encoder + transformer speech LM."""

    text_encoder_input_size: int = 512
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    text_token_size: int = 51866
    speech_token_size: int = 4096
    spk_embed_dim: int = 192
    lsm_weight: float = 0.0
    length_normalized_loss: bool = True
    text_encoder: GenericEncoderConfig = dataclasses.field(default_factory=_v1_text_encoder)
    llm: GenericEncoderConfig = dataclasses.field(default_factory=_v1_llm_encoder)
    # RAS sampling
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0

    @property
    def eos_token(self) -> int:
        return self.speech_token_size

    @property
    def full_vocab(self) -> int:
        return self.speech_token_size + 1  # the speech head's width (EOS last)


def _v1_hift() -> HiFTConfig:
    # 22.05 kHz, hop 8 * 8 * 4 = 256
    return HiFTConfig(
        sampling_rate=22050, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
        source_resblock_kernel_sizes=(7, 11),
        source_resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    )


def _v1_mel() -> MelConfig:
    # 22.05 kHz, 1024 / 256 / 1024
    return MelConfig(n_fft=1024, sampling_rate=22050, hop_size=256, win_size=1024)


def _v1_frontend() -> FrontendConfig:
    return FrontendConfig(target_sr=22050)


@dataclasses.dataclass(frozen=True)
class TTSV1Config:
    """The v1 model bundle (CosyVoice-300M) and its streaming constants."""

    llm: LMV1Config = dataclasses.field(default_factory=LMV1Config)
    flow: FlowV1Config = dataclasses.field(default_factory=FlowV1Config)
    hift: HiFTConfig = dataclasses.field(default_factory=_v1_hift)
    frontend: FrontendConfig = dataclasses.field(default_factory=_v1_frontend)
    mel: MelConfig = dataclasses.field(default_factory=_v1_mel)
    token_overlap_len: int = 20
    mel_cache_len: int = 20
    stream_scale_factor: float = 1.0
    # the 22.05 kHz path trims no prompt mel to the tokens: 0 means no alignment
    token_mel_ratio: int = 0

    @property
    def sample_rate(self) -> int:
        return self.flow.sample_rate

    @property
    def token_min_hop_len(self) -> int:
        return 2 * self.flow.input_frame_rate

    @property
    def token_max_hop_len(self) -> int:
        return 4 * self.flow.input_frame_rate

    @property
    def mel_overlap_len(self) -> int:
        # the token overlap in mel frames
        return int(self.token_overlap_len / self.flow.input_frame_rate
                   * self.flow.sample_rate / self.flow.mel_hop)

    @property
    def source_cache_len(self) -> int:
        return self.mel_cache_len * self.flow.mel_hop


def tiny_test_config() -> TTSConfig:
    """A miniature config for fast unit tests (same topology, tiny dims)."""

    backbone = Qwen2Config(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
    )
    llm = LMConfig(backbone=backbone, speech_token_size=81, max_seq_len=256)
    encoder = ConformerConfig(
        input_size=64,
        output_size=64,
        attention_heads=4,
        linear_units=128,
        num_blocks=2,
        num_up_blocks=1,
    )
    estimator = EstimatorConfig(
        in_channels=4 * 16,
        out_channels=16,
        channels=(32,),
        attention_head_dim=8,
        n_blocks=1,
        num_mid_blocks=2,
        num_heads=4,
    )
    flow = FlowConfig(
        input_size=64,
        output_size=16,
        vocab_size=81,
        encoder=encoder,
        estimator=estimator,
        cfm=CFMConfig(rand_noise_frames=2048),
    )
    hift = HiFTConfig(
        in_channels=16,
        base_channels=32,
        nb_harmonics=2,
        upsample_rates=(8, 5, 3),
        upsample_kernel_sizes=(16, 11, 7),
        f0_predictor=F0PredictorConfig(in_channels=16, cond_channels=32),
    )
    return TTSConfig(llm=llm, flow=flow, hift=hift)


def config_to_dict(cfg) -> dict:
    """Nested dataclass -> plain dict (JSON-serializable)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [config_to_dict(v) for v in cfg]
    return cfg


def config_from_dict(cls, data: dict):
    """A frozen dataclass from a dict: the fields ``data`` names (lists as
    tuples, a list of lists as a tuple of tuples, a dict under a dataclass
    field as that dataclass, built the same way, or as the ``BACKBONES``
    class its ``model_type`` names), the defaults for the rest."""
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if isinstance(v, dict) and dataclasses.is_dataclass(hints.get(f.name)):
            v = config_from_dict(BACKBONES.get(v.get("model_type"), hints[f.name]), v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def load_config(path: str | None = None, overrides: dict | None = None) -> TTSConfig:
    """TTSConfig from a JSON file plus nested overrides, e.g.
    ``load_config(overrides={"llm": {"top_p": 0.9}, "chunk_size": 50})``;
    what neither gives keeps ``TTSConfig()``'s value."""
    import json

    if not path and not overrides:
        return TTSConfig()
    data = config_to_dict(TTSConfig())
    if path:
        with open(path) as f:
            _merge(data, json.load(f))
    if overrides:
        _merge(data, overrides)
    return config_from_dict(TTSConfig, data)
