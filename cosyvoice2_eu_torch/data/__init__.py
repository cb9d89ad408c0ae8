"""Corpus acquisition and curation tooling (offline, on the host)."""
