"""Port of ``src/repro/optim/``."""
