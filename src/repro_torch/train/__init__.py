"""Port of ``src/repro/train/``."""
