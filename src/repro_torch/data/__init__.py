"""Port of ``src/repro/data/``."""
