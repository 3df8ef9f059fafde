"""attn_ms: device ms a traced step of the program's ``attn`` span
(``models/layers.py`` ``attention_block``: the projections, RoPE,
``chunked_attention`` and ``wo``, in the forward, the recompute and the
backward), the mean over ranks; absent where no trace holds the span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "attn")
