"""Command-line tools of the PyTorch port: checkpoint extraction, data
preparation, corpus curation, checkpoint conversion and the card's
diagnostics."""
