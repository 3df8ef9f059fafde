"""moe_shared_ms: device ms a traced step of the program's ``moe.shared``
span (``models/moe.py`` ``sigmoid_moe_block``: the shared expert's FFN
over every token, in the forward, the recompute and the backward), the
mean over ranks; absent where no trace holds the span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "moe.shared")
