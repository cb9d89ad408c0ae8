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
class LMConfig:
    """Speech-token LM wrapper around the Qwen2 backbone."""

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
