"""Vocoder: ms of HiFT (the timer's ``hift`` stage, every sub-batch of the
window) per second of audio delivered in the window."""


def read(ctx):
    stage = ctx["timer"].get("hift")
    if not stage or not ctx["audio_s"]:
        return None
    return 1e3 * stage["total_s"] / ctx["audio_s"]
