"""moe_dispatch_ms: device ms a traced step of the program's
``moe.dispatch`` span (``models/moe.py`` ``moe_block``: routing, the
scatter into the capacity buffers and the combine, in the forward, the
recompute and the backward), the mean over ranks; absent where no trace
holds the span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "moe.dispatch")
