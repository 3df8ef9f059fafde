"""moe_drop_pct: the (token, expert) pairs the MoE blocks dropped past
capacity over those they were assigned, in %, over the traced steps (the
program's ``moe.dropped`` and ``moe.assigned`` span counters, read by
``StepProgram.report()``; the mean over ranks); absent where the program
counted none: an untraced run, or a program without the counters."""

from bench.metrics._common import mean


def read(run):
    per = []
    for r in run["ranks"]:
        c = r.get("program_report", {}).get("counters", {})
        if c.get("moe.assigned"):
            per.append(100.0 * c.get("moe.dropped", 0) / c["moe.assigned"])
    return mean(per)
