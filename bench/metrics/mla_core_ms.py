"""mla_core_ms: device ms a traced step of the program's ``mla.core`` span
(``models/layers.py`` ``mla_core``: causal attention over MLA's expanded
heads, in the forward, the recompute and the backward), the mean over
ranks; absent where no trace holds the span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "mla.core")
