"""Serving engines, paged KV management and the continuous-batching
scheduler (ports of ``src/repro/serving/``)."""
