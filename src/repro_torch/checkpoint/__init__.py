"""Port of ``src/repro/checkpoint/``."""
