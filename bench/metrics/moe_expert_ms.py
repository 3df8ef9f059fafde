"""moe_expert_ms: device ms a traced step of the program's ``moe.experts``
span (``models/moe.py`` ``_experts``: the expert FFN's batched GEMMs, its
TP combine and the ep all_to_alls, in the forward, the recompute and the
backward), the mean over ranks; absent where no trace holds the span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "moe.experts")
