"""cosyvoice2_eu_torch — the PyTorch/CUDA port of the CosyVoice2-EU framework.

It stands beside the JAX package ``cosyvoice2_eu_tpu`` (the reference) and
imports neither JAX nor that package.  Entry points run on the GPU unless the
caller asks for the CPU:

    import cosyvoice2_eu_torch as cosy
    model = cosy.load(model_dir="CosyVoice2-EU")  # reference checkpoints + ONNX frontend
    wav, sr = model.tts("Bonjour !", "prompt.wav")   # a wav prompt, cloned on the card
    for chunk in model.stream("Bonjour !", "prompt.wav"):  # (1, t) float32 chunks
        ...
    wav, sr = model.tts("Bonjour !", "prompt.wav", mode="instruct2",
                        instruct_text="Parle lentement.")
    model = cosy.load(seed=0, download=False)      # random weights, on "cuda"
    wav, sr = model.tts("Bonjour !", prompt)       # prompt: dict of artifacts
    int8 = cosy.load(seed=0, download=False, lm_quant="int8")  # int8 LM (kernel K2)
    for chunk in model.stream_text(iter(["Bonjour ", "tout le ", "monde."]), prompt):
        ...                                       # text in as it arrives (bistream)
    qwen3 = cosy.load(backbone="hf:Qwen/Qwen3-0.6B", seed=0, download=False)
    v1, frontend, cfg = cosy.load_v1(seed=0)     # CosyVoice-300M (v1), random weights
    for chunk in v1.tts(text_ids, prompt_text_ids, prompt_speech_tokens, prompt_feat,
                        embedding, stream=True):  # (t,) float32 chunks at 22.05 kHz
        ...

``load`` sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False: HiFT's fp32 phase math
does not tolerate TF32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from cosyvoice2_eu_torch.config import TTSConfig

__version__ = "0.1.0"
__all__ = ["load", "load_v1", "Cosy2EU", "TTSConfig", "resolve_checkpoint_files",
           "resolve_backbone", "__version__"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, "none": None}


def resolve_checkpoint_files(
    model_dir: str,
    setting: str = "llm_flow_hifigan",
    llm_run_id: Optional[str] = None,
    flow_run_id: Optional[str] = None,
    hifigan_run_id: Optional[str] = None,
    final: bool = True,
) -> dict:
    """The checkpoint-selection matrix, setting x run id x final -> paths.

    As the reference: ``final`` loads {llm,flow,hift}.pt; otherwise each
    component named in ``setting`` that has a run id loads
    ``{key}-{run_id}.pt`` and the rest ``{key}-original.pt``.  Where the
    ``.pt`` file is missing but a directory of the same stem exists (a
    native checkpoint that ``tools/extract_for_inference.py`` wrote from a
    training run, the port's or the JAX package's), the directory is
    resolved, and ``load`` reads it with ``runtime/checkpoint.py::load_pytree``.
    """
    if final:
        tokens = {"llm", "flow", "hifigan"}
    elif setting == "original":
        tokens = set()
    else:
        tokens = set(setting.split("_"))
        if tokens - {"llm", "flow", "hifigan"}:
            raise ValueError('setting must be "original" or underscore-joined subset of '
                             f"{{llm,flow,hifigan}}, got {setting!r}")
    chosen = {}
    for key, run_id in (("llm", llm_run_id), ("flow", flow_run_id), ("hift", hifigan_run_id)):
        token = "hifigan" if key == "hift" else key
        if final or (token in tokens and run_id is not None):
            suffix = "" if final else f"-{run_id}"
        else:
            suffix = "-original"
        path = os.path.join(model_dir, f"{key}{suffix}.pt")
        if not os.path.exists(path) and os.path.isdir(path[: -len(".pt")]):
            path = path[: -len(".pt")]  # a native checkpoint directory
        chosen[key] = path
    return chosen


class Cosy2EU:
    """High-level inference wrapper: ``tts`` returns the whole waveform,
    ``stream`` yields it chunk by chunk.

    A prompt is a wav path (read at 16 kHz and extracted once per (path,
    prompt text): the cache never evicts and does not notice a file
    rewritten in place, as the reference's), a 16 kHz waveform array, or a
    dict of artifacts (``prompt_feat``, ``speech_tokens``, ``embedding``).
    Modes: ``cross_lingual`` (default), ``zero_shot`` and ``instruct2``
    (with ``instruct_text``)."""

    def __init__(self, model, frontend, cfg: TTSConfig):
        self._model = model
        self._frontend = frontend
        self._cfg = cfg
        self._prompt_cache: dict = {}

    @property
    def sample_rate(self) -> int:
        return self._cfg.sample_rate

    def _prepare(self, prompt, prompt_text: str = "", **precomputed):
        if isinstance(prompt, str):
            key = (prompt, prompt_text)
            if key not in self._prompt_cache:
                from cosyvoice2_eu_torch.frontend.frontend import load_wav

                with self._frontend.timer.stage("prompt_load_wav"):
                    wav = load_wav(prompt, self._cfg.frontend.prompt_sr)
                self._prompt_cache[key] = self._frontend.extract_prompt(
                    wav, prompt_text, **precomputed)
            return self._prompt_cache[key]
        if isinstance(prompt, dict):
            missing = {"prompt_feat", "speech_tokens", "embedding"} - prompt.keys()
            if missing:
                raise ValueError(
                    f"prompt dict is missing {sorted(missing)}; expected the artifact keys "
                    "prompt_feat, speech_tokens, embedding (and optionally prompt_text) as "
                    "produced by Frontend.extract_prompt")
            return prompt
        return self._frontend.extract_prompt(np.asarray(prompt), prompt_text, **precomputed)

    def tts(
        self,
        text: str,
        prompt,
        *,
        prompt_text: str = "",
        speed: float = 1.0,
        text_frontend: bool = False,
        mode: str = "cross_lingual",
        instruct_text: str = "",
        **precomputed,
    ) -> Tuple[np.ndarray, int]:
        """Synthesize; returns (waveform (1, T) float32, sample_rate)."""
        chunks = list(self._generate(text, prompt, prompt_text, False, speed, text_frontend,
                                     mode, instruct_text, **precomputed))
        return np.concatenate(chunks)[None], self.sample_rate

    def stream(
        self,
        text: str,
        prompt,
        *,
        prompt_text: str = "",
        speed: float = 1.0,
        text_frontend: bool = False,
        mode: str = "cross_lingual",
        instruct_text: str = "",
        **precomputed,
    ) -> Iterator[np.ndarray]:
        """Yield waveform chunks (1, t) float32 for streaming playback."""
        for chunk in self._generate(text, prompt, prompt_text, True, speed, text_frontend, mode,
                                    instruct_text, **precomputed):
            yield chunk[None]

    def _generate(self, text, prompt, prompt_text, stream, speed, text_frontend, mode,
                  instruct_text="", **precomputed):
        prompt_art = self._prepare(prompt, prompt_text, **precomputed)
        segments = (self._frontend.normalize_text(text, split=True) if text_frontend
                    else [text])
        if mode == "instruct2":
            def build(seg, art):
                return self._frontend.frontend_instruct2(seg, instruct_text, art)
        elif mode in ("zero_shot", "cross_lingual"):
            build = getattr(self._frontend, f"frontend_{mode}")
        else:
            raise ValueError(f"unknown mode {mode!r}")
        for seg in segments:
            yield from self._model.tts(build(seg, prompt_art), stream=stream, speed=speed)

    def stream_text(
        self,
        text_iter,
        prompt,
        *,
        prompt_text: str = "",
        speed: float = 1.0,
        **precomputed,
    ) -> Iterator[np.ndarray]:
        """Streaming text in, streaming audio out: each text piece (from an
        upstream LLM, say) is tokenized on its own as it arrives (empty
        pieces are skipped) and drives the LM's fill-token protocol
        (zero-shot); yields waveform chunks (1, t) float32."""
        prompt_art = self._prepare(prompt, prompt_text, **precomputed)
        inputs = self._frontend.frontend_zero_shot("", prompt_art)

        def chunks():
            for piece in text_iter:
                toks = self._frontend.text_tokens(piece)
                if len(toks):
                    yield toks

        for chunk in self._model.tts_stream_text(chunks(), inputs, speed=speed):
            yield chunk[None]

    def add_zero_shot_spk(self, prompt_text: str, prompt, spk_id: str) -> bool:
        """Store a prompt's artifacts (from a wav path, a waveform or a dict)
        under ``spk_id`` in the frontend's speaker store
        (``_frontend.get_spk(spk_id)`` gives them back)."""
        return self._frontend.add_zero_shot_spk(spk_id, self._prepare(prompt, prompt_text))


def resolve_backbone(backbone: Optional[str], model_dir: Optional[str] = None):
    """The reference's ``--backbone`` surface -> (backbone config or None,
    tokenizer dir or None, use_bistream).

    None or "blanken" keep the default Qwen2-0.5B BlankEN backbone
    (unistream decode).  "hf:<id-or-path>", "local:<path>" or a bare path
    name an alternative HF backbone, read from the ``config.json`` at the
    path (``model_type`` "qwen3" turns on the per-head q/k norms); a path
    without one whose name says Qwen3 gets ``qwen3_0_6b_config`` (the
    published Qwen3-0.6B widths, nothing downloaded); anything else raises
    ValueError.  An alternative backbone decodes through the bistream
    fill-token protocol, as the reference routes them.  ``model_dir`` is
    not read (the reference's signature).
    """
    if backbone in (None, "blanken"):
        return None, None, False
    path = backbone.split(":", 1)[1] if backbone.startswith(("hf:", "local:")) else backbone
    cfg_json = os.path.join(path, "config.json")
    if os.path.exists(cfg_json):
        import json

        from cosyvoice2_eu_torch.config import Qwen2Config

        with open(cfg_json) as f:
            hf = json.load(f)
        heads = hf.get("num_attention_heads", 14)
        model_type = hf.get("model_type", "qwen2")
        bb = Qwen2Config(
            vocab_size=hf.get("vocab_size", 151936),
            hidden_size=hf.get("hidden_size", 896),
            intermediate_size=hf.get("intermediate_size", 4864),
            num_layers=hf.get("num_hidden_layers", 24),
            num_heads=heads,
            num_kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim", hf.get("hidden_size", 896) // heads),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 1_000_000.0),
            use_qk_norm=model_type == "qwen3",
            attention_bias=hf.get("attention_bias", model_type == "qwen2"),
        )
        return bb, path, True
    if "qwen3" in path.lower().replace("-", "").replace("_", ""):
        from cosyvoice2_eu_torch.config import qwen3_0_6b_config

        return qwen3_0_6b_config(), None, True
    raise ValueError(f"cannot resolve backbone {backbone!r}: no config.json at {path} "
                     "(pass a local checkout)")


def _snapshot_download(repo_id: str, required: bool = False) -> Optional[str]:
    """The hub snapshot of ``repo_id`` in ``$COSY2EU_CACHE`` (default
    ~/.cache/cosyvoice2-eu), as the reference's install-and-run path.
    Returns the local dir, or None when ``huggingface_hub`` or the network
    is missing and the download was only opportunistic (a snapshot cached
    earlier is still used offline); with ``required`` it raises instead."""
    target = os.path.expanduser(os.environ.get("COSY2EU_CACHE", "~/.cache/cosyvoice2-eu"))
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        if required:
            raise ImportError("load(download=True) needs huggingface_hub; pass model_dir= "
                              "with a local checkout instead") from None
        return None
    try:
        snapshot_download(repo_id=repo_id, local_dir=target, etag_timeout=10)
        return target
    except Exception:
        if required:
            raise
        if os.path.exists(os.path.join(target, "llm.pt")) or os.path.isdir(
                os.path.join(target, "original")):
            return target
        import logging

        logging.getLogger(__name__).warning(
            "snapshot_download(%s) failed and no cached copy at %s; building a "
            "random-initialized model (pass model_dir= for real weights)", repo_id, target)
        return None


def load(
    *,
    model_dir: Optional[str] = None,
    repo_id: str = "hi-paris/CosyVoice2-0.5B-EU",
    download: Optional[bool] = None,
    config: Optional[TTSConfig] = None,
    seed: int = 0,
    params: Optional[dict] = None,
    compute_dtype="bfloat16",
    device: str | torch.device = "cuda",
    setting: str = "llm_flow_hifigan",
    llm_run_id: Optional[str] = None,
    flow_run_id: Optional[str] = None,
    hifigan_run_id: Optional[str] = None,
    final: Optional[bool] = None,
    backbone: Optional[str] = None,
    lm_quant: Optional[str] = None,
    tp: int = 0,
) -> Cosy2EU:
    """Build the model once and reuse it for many calls.

    The weights, in this order: ``params`` (a {"llm", "flow", "hift"} tree
    of numpy arrays or tensors, e.g. the JAX package's parameters through
    ``np.asarray``); else the checkpoints in ``model_dir`` (``llm.pt``,
    ``flow.pt``, ``hift.pt``, picked by ``setting``, the run ids and
    ``final`` as ``resolve_checkpoint_files`` says: a reference ``.pt`` is
    converted by ``runtime/checkpoint.py``, a native directory, the port's
    or the JAX package's orbax one, is read as it is by ``load_pytree``); else random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  With no
    ``model_dir``, ``config`` or ``params``, the hub snapshot ``repo_id`` is
    fetched first (``_snapshot_download``: ``download=True`` requires it,
    ``download=False`` skips it, None tries it and goes on without).

    With ``model_dir`` the tokenizer comes from its tokenizer files (the
    byte tokenizer, with a warning, when it has none), its speaker store
    (``spk2info.pt``, else ``spk2info.npz``) fills ``_frontend.spk_info`` (a
    store that does not load raises), and its ``speech_tokenizer_v2.onnx``
    and ``campplus.onnx`` become the frontend's speech tokenizer and speaker
    embedding on ``device`` (``runtime/onnx_fallback.py``; a graph the
    structural converter cannot map runs through the ONNX graph executor,
    with a warning), so wav prompts work.

    ``config`` defaults to the published widths.  ``device`` defaults to
    "cuda" and raises when there is no GPU; pass "cpu" for the plain
    PyTorch path.  ``lm_quant="int8"`` stores the LM's projections as
    per-channel int8 (kernel K2 on the card); any value but None and "int8"
    raises.  ``backbone`` (``resolve_backbone``) takes None or "blanken"
    (the default Qwen2 backbone), or an alternative HF backbone
    ("hf:<id-or-path>", "local:<path>"), whose config replaces
    ``cfg.llm.backbone`` and whose LM decodes through the bistream
    fill-token protocol; its directory gives the tokenizer when it holds
    tokenizer files (a ``model_dir``'s ``llm.pt`` is converted at the
    backbone's widths).  Batched synthesis is ``load(...)._model.tts_batch(prompts)``
    over the frontend's ``PromptInputs``.
    """
    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice2_eu_torch.runtime.model import TTSModel
    from cosyvoice2_eu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if model_dir is None and config is None and params is None and download is not False:
        model_dir = _snapshot_download(repo_id, required=download is True)
    cfg = config or TTSConfig()
    bb_cfg, bb_tokenizer_dir, use_bistream = resolve_backbone(backbone, model_dir)
    if bb_cfg is not None:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, backbone=bb_cfg))
    if bb_tokenizer_dir is not None and not any(
            os.path.exists(os.path.join(bb_tokenizer_dir, f))
            for f in ("tokenizer.json", "vocab.json")):
        bb_tokenizer_dir = None  # a backbone checkout without tokenizer files
    if params is None and model_dir is not None:
        from cosyvoice2_eu_torch.runtime.checkpoint import (
            convert_flow,
            convert_hift,
            convert_llm,
            load_pytree,
            load_torch_state,
        )

        files = resolve_checkpoint_files(model_dir, setting, llm_run_id, flow_run_id,
                                         hifigan_run_id, final=True if final is None else final)

        def component(key, convert, sub_cfg):
            if os.path.isdir(files[key]):  # a native tree, already in the port's layout
                return load_pytree(files[key])
            return convert(load_torch_state(files[key]), sub_cfg)

        params = {"llm": component("llm", convert_llm, cfg.llm),
                  "flow": component("flow", convert_flow, cfg.flow),
                  "hift": component("hift", convert_hift, cfg.hift)}
    elif params is None:
        from cosyvoice2_eu_torch.models.flow import init_flow
        from cosyvoice2_eu_torch.models.hift import init_hift
        from cosyvoice2_eu_torch.models.llm import init_lm

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {"llm": init_lm(gen, cfg.llm), "flow": init_flow(gen, cfg.flow),
                  "hift": init_hift(gen, cfg.hift)}
    if isinstance(compute_dtype, str):
        compute_dtype = _DTYPES[compute_dtype]
    model = TTSModel(cfg, params, seed=seed, compute_dtype=compute_dtype, device=dev,
                     lm_quant=lm_quant, use_bistream=use_bistream, tp=tp)
    speech_tokenizer_fn = spk_embedding_fn = None
    if model_dir is not None:
        from cosyvoice2_eu_torch.runtime.onnx_fallback import load_frontend_fns

        speech_tokenizer_fn, spk_embedding_fn = load_frontend_fns(
            os.path.join(model_dir, "speech_tokenizer_v2.onnx"),
            os.path.join(model_dir, "campplus.onnx"), device=dev)
    frontend = Frontend(cfg, tokenizer=get_tokenizer(bb_tokenizer_dir or model_dir or ""),
                        speech_tokenizer_fn=speech_tokenizer_fn,
                        spk_embedding_fn=spk_embedding_fn, device=dev)
    if model_dir is not None:
        # the cached-speaker store (the reference's spk2info.pt)
        for name in ("spk2info.pt", "spk2info.npz"):
            spk_path = os.path.join(model_dir, name)
            if os.path.exists(spk_path):
                frontend.load_spk_info(spk_path)
                break
    return Cosy2EU(model, frontend, cfg)


def load_v1(
    *,
    model_dir: Optional[str] = None,
    config=None,
    params: Optional[dict] = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Load a v1 (CosyVoice-300M family) bundle -> ``(CosyVoice1Model,
    Frontend, TTSV1Config)``.

    The weights, in this order: ``params`` (a {"llm", "flow", "hift"} tree
    of numpy arrays or tensors); else the reference checkpoints in
    ``model_dir`` (``llm.pt``, ``flow.pt``, ``hift.pt``, converted by
    ``runtime/checkpoint_v1.py`` and ``convert_hift``); else random weights
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    ``config`` defaults to ``TTSV1Config()``, the published widths.  With
    ``model_dir``, its ``speech_tokenizer_v1.onnx`` and ``campplus.onnx``
    become the frontend's speech tokenizer and speaker embedding
    (``runtime/onnx_fallback.py``), its tokenizer files or ``*.tiktoken``
    ranks the text tokenizer (``frontend/tokenizer.py``), and its speaker
    store (``spk2info.pt``, else ``spk2info.npz``) fills
    ``Frontend.spk_info``.  The model runs in fp32.  ``device`` defaults to
    "cuda" and raises when there is no GPU; pass "cpu" for the plain path.
    """
    from cosyvoice2_eu_torch.config import TTSV1Config
    from cosyvoice2_eu_torch.frontend.frontend import Frontend
    from cosyvoice2_eu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice2_eu_torch.runtime.model_v1 import CosyVoice1Model
    from cosyvoice2_eu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = config or TTSV1Config()
    if params is None and model_dir is not None:
        from cosyvoice2_eu_torch.runtime.checkpoint import convert_hift, load_torch_state
        from cosyvoice2_eu_torch.runtime.checkpoint_v1 import convert_flow_v1, convert_llm_v1

        def state(name):
            return load_torch_state(os.path.join(model_dir, name))

        params = {"llm": convert_llm_v1(state("llm.pt"), cfg.llm),
                  "flow": convert_flow_v1(state("flow.pt"), cfg.flow),
                  "hift": convert_hift(state("hift.pt"), cfg.hift)}
    elif params is None:
        from cosyvoice2_eu_torch.models.flow_v1 import init_flow_v1
        from cosyvoice2_eu_torch.models.hift import init_hift
        from cosyvoice2_eu_torch.models.llm_v1 import init_lm_v1

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {"llm": init_lm_v1(gen, cfg.llm), "flow": init_flow_v1(gen, cfg.flow),
                  "hift": init_hift(gen, cfg.hift)}
    model = CosyVoice1Model(cfg, params, seed=seed, device=dev)
    speech_tokenizer_fn = spk_embedding_fn = None
    if model_dir is not None:
        from cosyvoice2_eu_torch.runtime.onnx_fallback import load_frontend_fns

        speech_tokenizer_fn, spk_embedding_fn = load_frontend_fns(
            os.path.join(model_dir, "speech_tokenizer_v1.onnx"),
            os.path.join(model_dir, "campplus.onnx"), device=dev)
    frontend = Frontend(cfg, tokenizer=get_tokenizer(model_dir or ""),
                        speech_tokenizer_fn=speech_tokenizer_fn,
                        spk_embedding_fn=spk_embedding_fn, device=dev)
    if model_dir is not None:
        for name in ("spk2info.pt", "spk2info.npz"):
            spk_path = os.path.join(model_dir, name)
            if os.path.exists(spk_path):
                frontend.load_spk_info(spk_path)
                break
    return model, frontend, cfg
