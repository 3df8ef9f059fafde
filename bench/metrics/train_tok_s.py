"""train_tok_s: every token the window's steps trained, on all ranks,
over the window's wall time (barrier to synchronize and barrier)."""

from bench.metrics._common import tokens_per_step, window_s


def read(run):
    return run["ranks"][0]["steps"] * tokens_per_step(run) / window_s(run)
