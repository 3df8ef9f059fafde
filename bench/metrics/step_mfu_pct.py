"""step_mfu_pct: the whole step's model FLOPs (bench/flops/) times the
window's steps, over the window's wall time times the chips times one
chip's bf16 dense peak (bench/peaks.json)."""

from bench.metrics._common import step_flops, window_s


def read(run):
    peak = run["peaks"].get("bf16_flops_per_s")
    if not peak:
        return None
    steps = run["ranks"][0]["steps"]
    return 100.0 * step_flops(run) * steps / (window_s(run) * run["chips"]
                                              * peak)
