"""Training loops (port of ``repro/train/``)."""
