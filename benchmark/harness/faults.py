"""Faults planted in the timed path, to show that the output check sees
them (``tests/test_bench_runs.py`` at the tiny size, ``tools/readings.py
--fault`` at a cell's own size on the card).  Each is (module, attribute,
wrapper): ``plant`` replaces the attribute with the wrapped original and
returns a function that puts it back."""

from __future__ import annotations

import importlib


def _alter_tokens(fn):
    """Every served token moved to the next id, where it is produced."""
    def f(params, cfg, *a, **k):
        tokens, lengths, steps = fn(params, cfg, *a, **k)
        return (tokens + 1) % cfg.speech_token_size, lengths, steps
    return f


def _alter_mel(fn):
    return lambda *a, **k: fn(*a, **k) + 0.5


def _alter_wav(fn):
    def f(*a, **k):
        audio, source = fn(*a, **k)
        return audio * 0.9, source
    return f


def _state_unchanged(fn):
    """The optimizer's step hands back the parameters it was given."""
    return lambda self, params, grads, state: (params, fn(self, params, grads, state)[1])


def _half_batch(fn):
    """The loss over the first half of the batch's rows (and draws), the
    mean taken over them alone."""
    def half(x):
        if isinstance(x, dict):
            return {k: v[: max(1, v.shape[0] // 2)] for k, v in x.items()}
        return x

    def f(params, cfg, batch, *a, **k):
        return fn(params, cfg, half(batch), *(half(x) for x in a), **k)
    return f


FAULTS = {
    ("tts_batch", "token_altered"): ("cosyvoice2_eu_torch.models.llm", "lm_decode", _alter_tokens),
    ("tts_batch", "mel_altered"): ("cosyvoice2_eu_torch.runtime.model", "flow_inference",
                                   _alter_mel),
    ("tts_batch", "wav_altered"): ("cosyvoice2_eu_torch.runtime.model", "hift_inference",
                                   _alter_wav),
    ("lm_train", "state_unchanged"): ("cosyvoice2_eu_torch.train.optim", "Optimizer.step",
                                      _state_unchanged),
    ("lm_train", "half_batch"): ("cosyvoice2_eu_torch.parallel.train_step", "lm_loss_fn",
                                 _half_batch),
    ("flow_train", "state_unchanged"): ("cosyvoice2_eu_torch.train.optim", "Optimizer.step",
                                        _state_unchanged),
    ("flow_train", "half_batch"): ("cosyvoice2_eu_torch.parallel.train_step", "flow_loss_fn",
                                   _half_batch),
}


def plant(driver: str, fault: str):
    mod_name, attr, wrap = FAULTS[(driver, fault)]
    target = importlib.import_module(mod_name)
    if "." in attr:
        cls, attr = attr.split(".")
        target = getattr(target, cls)
    original = getattr(target, attr)
    setattr(target, attr, wrap(original))
    return lambda: setattr(target, attr, original)
