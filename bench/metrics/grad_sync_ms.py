"""grad_sync_ms: device time a traced step of the gradient sync's work:
NCCL's kernels, K1 and the copies on the sync's side stream, summed (the
mean over ranks); absent where nothing of the kind ran."""

from bench.metrics._common import is_comm, mean, traced


def read(run):
    per = []
    for t in traced(run):
        us = sum(op[2] for op in t["ops"] if is_comm(op, t["main_stream"]))
        if us:
            per.append(us / 1e3 / t["steps"])
    return mean(per)
