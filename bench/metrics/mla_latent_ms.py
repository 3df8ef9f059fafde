"""mla_latent_ms: device ms a traced step of the program's ``mla.latent``
span (``models/layers.py`` ``mla_core``: the low-rank query and key/value
projections, their norms and the RoPE of q_rope and the shared k_rope,
in the forward, the recompute and the backward), the mean over ranks;
absent where no trace holds the span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "mla.latent")
