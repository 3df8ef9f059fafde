"""The span reading (``bench/spans.py``) and the counter reader
(``metrics/moe_drop_pct.py``).

A fixed synthetic Chrome trace: a ``step`` range on the main thread with
``attn``, ``moe.experts`` (a ``route.primary`` range nested in it) and
``adamw`` inside; a backward ``attn`` range on autograd's thread with a
launch in it; a launch outside every range; a kernel on a side stream
overlapping the compute stream; a device op whose launch the trace lacks.
On it ``trace.summarize`` gives the ops, launches, busy time, gaps and
wall it gave before spans existed, and ``spans.summarize`` puts each
device op in the spans around its launch."""

import pytest

from bench import cells, run, spans
from bench import trace as TR
from bench.drivers import train
from bench.metrics import moe_drop_pct
from bench.tests._small import small_cell, small_files

MAIN, BWD = 1, 2          # the host threads
COMPUTE, SIDE = 7, 9      # the streams
WALL_S = 0.0012


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def _launch(corr, ts, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid,
              correlation=corr)


def _kernel(name, corr, ts, dur, stream=COMPUTE, cat="kernel"):
    return _x(cat, name, ts, dur, tid=stream, stream=stream,
              correlation=corr)


EVENTS = [
    _x("user_annotation", "step program-0", 0, 1000),
    _x("user_annotation", "attn", 100, 200),
    _x("user_annotation", "moe.experts", 400, 100),
    _x("user_annotation", "route.primary 4096", 420, 30),
    _x("user_annotation", "adamw", 800, 150),
    _x("user_annotation", "attn", 500, 100, tid=BWD),
    _x("cpu_op", "aten::mm", 110, 50),
    _x("cpu_op", "aten::add", 850, 20),
    _x("cpu_op", "aten::copy_", 960, 10),
    _x("cpu_op", "aten::fill_", 1100, 5),
    _x("cpu_op", "aten::mm", 510, 40, tid=BWD),
    {"ph": "i", "cat": "cpu_instant_event", "name": "mark", "ts": 5},
    _launch(1, 120), _launch(2, 430), _launch(7, 440), _launch(3, 520, BWD),
    _launch(4, 860), _launch(5, 965), _launch(6, 1100),
    _kernel("k1", 1, 200, 100),
    _kernel("k2", 2, 300, 50),
    _kernel("k7", 7, 320, 40, stream=SIDE),
    _kernel("k3", 3, 400, 100),
    _kernel("k4", 4, 900, 60),
    _kernel("k5", 5, 1000, 40),
    _kernel("Memset (Device)", 6, 1100, 10, cat="gpu_memset"),
    _kernel("k8", 99, 1200, 10),
]


def test_trace_summary_is_as_before():
    """The summary every existing reader takes, on the synthetic trace."""
    got = TR.summarize(EVENTS, 2, WALL_S)
    assert got["ops"] == [("k1", 200.0, 100.0, COMPUTE),
                          ("k2", 300.0, 50.0, COMPUTE),
                          ("k7", 320.0, 40.0, SIDE),
                          ("k3", 400.0, 100.0, COMPUTE),
                          ("k4", 900.0, 60.0, COMPUTE),
                          ("k5", 1000.0, 40.0, COMPUTE),
                          ("Memset (Device)", 1100.0, 10.0, COMPUTE),
                          ("k8", 1200.0, 10.0, COMPUTE)]
    assert got["launches"] == 7 and got["steps"] == 2
    assert got["wall_s"] == WALL_S
    assert got["busy_s"] == pytest.approx(380e-6)
    assert set(got) == {"ops", "launches", "busy_s", "wall_s", "steps",
                        "gaps"}
    want = {"aten::mm": 40e-6, "aten::add": 400e-6, "aten::copy_": 40e-6,
            "aten::fill_": 60e-6, "unknown": 90e-6,
            "outside the device's span": 190e-6}
    assert got["gaps"] == pytest.approx(want)
    assert TR.main_stream(got["ops"]) == COMPUTE


def test_spans_take_the_device_time_launched_inside_them():
    """Nested spans hold their children's device time; a launch on the
    backward thread goes to its ``attn`` range; one outside every range
    to none; the side stream's kernel to the range that launched it."""
    got = spans.summarize(EVENTS, WALL_S)
    sp = got["spans"]
    us = {n: round(v["device_s"] * 1e6, 6) for n, v in sp.items()}
    assert us == {"step": 290.0, "attn": 200.0, "moe.experts": 90.0,
                  "route.primary": 90.0, "adamw": 60.0}
    host = {n: round(v["host_s"] * 1e6, 6) for n, v in sp.items()}
    assert host == {"step": 1000.0, "attn": 300.0, "moe.experts": 100.0,
                    "route.primary": 30.0, "adamw": 150.0}
    assert {n: v["count"] for n, v in sp.items()} == {
        "step": 1, "attn": 2, "moe.experts": 1, "route.primary": 1,
        "adamw": 1}
    assert got["device_s"] == pytest.approx(410e-6)
    assert got["ranges"]["route.primary"] == [["4096", 420.0, 30.0, 90.0,
                                               360.0]]
    assert got["ranges"]["step"] == [["program-0", 0.0, 1000.0, 290.0,
                                      1040.0]]
    ms = spans.per_step(got, 1)
    assert ms == pytest.approx({"attn": 0.2, "moe.dispatch": 0.0,
                                "moe.experts": 0.09, "adamw": 0.06,
                                "outside_ms": 0.06})


def test_gaps_by_span_name_the_span_and_the_host_op():
    got = spans.summarize(EVENTS, WALL_S)["gaps_by_span"]
    assert got == pytest.approx({
        "attn / aten::mm": 40e-6, "adamw / aten::add": 400e-6,
        "step / aten::copy_": 40e-6, "outside any span / aten::fill_": 60e-6,
        "unknown / unknown": 90e-6, "outside the device's span": 190e-6})
    # the same gaps as the summary's, named further
    assert sum(got.values()) == pytest.approx(
        sum(TR.summarize(EVENTS, 2, WALL_S)["gaps"].values()))


def test_same_name_nesting_counts_host_time_once():
    events = [_x("user_annotation", "route.staged 8", 0, 100),
              _x("user_annotation", "route.staged 4", 10, 50),
              _launch(1, 20), _kernel("k", 1, 200, 30)]
    sp = spans.summarize(events, 0.001)["spans"]["route.staged"]
    assert sp["count"] == 2
    assert sp["host_s"] == pytest.approx(100e-6)
    assert sp["device_s"] == pytest.approx(30e-6)


@pytest.mark.parametrize("report,want", [
    ({"program": "p"}, None),
    ({"program": "p", "counters": {}}, None),
    ({"program": "p", "counters": {"moe.assigned": 400,
                                   "moe.dropped": 10}}, 2.5),
    ({"program": "p", "counters": {"moe.assigned": 400}}, 0.0),
], ids=["parent", "empty", "counted", "none-dropped"])
def test_moe_drop_pct_reads_the_program_counters(report, want):
    run_ = {"ranks": [{"program_report": report}]}
    assert moe_drop_pct.read(run_) == want


@pytest.fixture(scope="module")
def traced_small():
    """A traced CPU run of the cell at a small size, and its line."""
    spec = small_cell("mixtral-8x7b.train-1chip", trace=True)
    ranks = train.run_cell(spec)
    out = run.assemble(spec["cell"]["name"], small_files(spec), ranks,
                       True, {})
    return ranks, out


def test_moe_drop_pct_only_in_a_traced_run(traced_small):
    """A CPU run of the cell at a small size: the untraced line has no
    ``moe_drop_pct``, the traced one has it, a share of the pairs."""
    spec = small_cell("mixtral-8x7b.train-1chip")
    ranks = train.run_cell(spec)
    assert moe_drop_pct.read({"ranks": ranks}) is None
    ranks, out = traced_small
    assert out["correct"], out["checks"]
    value = out["metrics"]["moe_drop_pct"]["value"]
    assert 0.0 <= value < 100.0
    counters = ranks[0]["program_report"]["counters"]
    # 3 traced steps, 2 layers, 64 tokens, top-2
    assert counters["moe.assigned"] == train.TRACE_STEPS * 2 * 64 * 2


SPAN_READERS = {"attn_ms": "attn", "moe_dispatch_ms": "moe.dispatch",
                "moe_expert_ms": "moe.experts", "optimizer_ms": "adamw"}


def test_span_readers_on_the_synthetic_trace():
    """Each reader gives its span's device ms over the traced steps, the
    mean over ranks; none where no rank's trace holds the span."""
    sp = spans.summarize(EVENTS, WALL_S)["spans"]
    one = {"trace": {"spans": sp, "steps": 2}}
    half = {"trace": {"spans": {n: dict(v, device_s=v["device_s"] / 2)
                                for n, v in sp.items()}, "steps": 2}}
    want = {"attn_ms": 0.1, "moe_dispatch_ms": None, "moe_expert_ms": 0.045,
            "optimizer_ms": 0.03}
    for metric, value in want.items():
        reader = cells.reader(metric)
        if value is None:
            assert reader.read({"ranks": [one, half]}) is None
        else:
            assert reader.read({"ranks": [one]}) == pytest.approx(value)
            assert reader.read({"ranks": [one, half]}) == pytest.approx(
                0.75 * value)
    assert cells.reader("attn_ms").read({"ranks": [{}]}) is None


def test_traced_run_carries_the_program_spans(traced_small):
    """The traced run's summary holds the program's spans and the gaps by
    span, the line's breakdown the gaps by span, and the four readers
    each give a value (0 ms on the CPU, which runs no device op)."""
    ranks, out = traced_small
    t = ranks[0]["trace"]
    assert set(SPAN_READERS.values()) | {"step"} <= set(t["spans"])
    # 3 steps of 2 layers: each layer's forward, recompute and backward
    assert t["spans"]["attn"]["count"] == 3 * train.TRACE_STEPS * 2
    assert t["spans"]["adamw"]["count"] == train.TRACE_STEPS
    assert sum(t["gaps_by_span"].values()) == pytest.approx(
        sum(t["gaps"].values()))
    for metric, span in SPAN_READERS.items():
        assert out["metrics"][metric]["unit"] == "ms/step"
        assert out["metrics"][metric]["value"] == pytest.approx(
            1e3 * t["spans"][span]["device_s"] / t["steps"])
    assert len(out["breakdown"]["idle_gaps_by_span"]) <= 10
