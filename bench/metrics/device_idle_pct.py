"""device_idle_pct: 1 minus the union of the device's operations over the
traced steps' wall time, in percent; the mean over ranks."""

from bench.metrics._common import mean, traced


def read(run):
    return mean([100.0 * (1 - t["busy_s"] / t["wall_s"])
                 for t in traced(run) if t["busy_s"] > 0])
