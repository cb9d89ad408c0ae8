"""Orchestrator / speech LM: ms of ``tts_batch``'s LM (the timer's
``lm_decode`` stage: prefill and every decode step, synchronised at its end)
per decode step of the window."""


def read(ctx):
    stage = ctx["timer"].get("lm_decode")
    if not stage or not ctx["decode_steps"]:
        return None
    return 1e3 * stage["total_s"] / ctx["decode_steps"]
