"""optimizer_ms: device ms a traced step of the program's ``adamw`` span
(``optim/adamw.py`` ``apply_updates``: the global norm and the update,
K8 on the card), the mean over ranks; absent where no trace holds the
span."""

from bench.metrics._common import span_ms


def read(run):
    return span_ms(run, "adamw")
