"""Serving: the per-request streaming session (``engine.StreamSession``)."""
