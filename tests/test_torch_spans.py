"""The port's spans and counters (``runtime/spans.py``) on the CPU.

A Mixtral-shaped config a few widths wide (reduced mixtral-8x7b: 2
layers of attention + 4 experts, top-2 at capacity 1.25), trained by
``build_train_program`` on one device.  With the profiler off the step's
autograd graph holds no span marker; the parameters after 3 steps are
bit for bit the same traced and untraced, under each ``remat``.  Under
the CPU profiler, every backward op whose forward op (the same
``Sequence number``) lies in ``attn``, ``moe.dispatch`` or
``moe.experts`` lies in that same span, the checkpoint's recompute
included; there is one ``step`` span a step; and the MoE counters equal
a direct count of ``dispatch_indices``' drops on the same inputs, once a
step, not doubled by the recompute.  ``StepProgram.lower`` on meta
arguments runs under the profiler and counts nothing.  On 2 gloo ranks
with a mixed plan, each ``route.<path>`` span carries the bytes of that
path's segment (rank side in ``_torch_ranks.route_spans``).
"""

import contextlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_ranks
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import build_train_program, local_batch
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime import spans
from repro_torch.runtime.program import meta_like

CFG = get_config("mixtral-8x7b").reduced(d_model=64, n_experts=4, vocab=256)
SEQ, BATCH = 64, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
#: the spans whose region's backward the markers name
REGIONS = ("attn", "moe.dispatch", "moe.experts")
MARKERS = ("_OpenBackward", "_CloseBackward")
BWD = "autograd::engine::evaluate_function: "


def _batch(k):
    rng = np.random.default_rng(100 + k)
    return {n: rng.integers(0, CFG.vocab, (BATCH, SEQ)).astype(np.int32)
            for n in ("tokens", "labels")}


def _start(remat=True):
    prog, ctx = build_train_program(CFG, None, opt=OPT, remat=remat,
                                    device="cpu")
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return prog, ctx, params, init_state(params)


def _events(prof):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


class _Spans:
    """The user_annotation ranges of a trace by thread: the innermost
    one around a host time."""

    def __init__(self, events):
        self.by_tid = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation":
                ts = float(e["ts"])
                self.by_tid.setdefault(e["tid"], []).append(
                    (ts, ts + float(e["dur"]), e["name"].split(" ")[0]))

    def at(self, tid, ts):
        inner = None
        for a, b, name in self.by_tid.get(tid, []):
            if a <= ts <= b and (inner is None or a >= inner[0]):
                inner = (a, name)
        return inner[1] if inner else None

    def names(self):
        return [n for rows in self.by_tid.values() for _, _, n in rows]


@pytest.fixture(scope="module")
def traced():
    """Two profiled steps after one untraced one (remat=True): the trace,
    the counters of the profiled steps and a direct count of the drops of
    the first profiled step's inputs."""
    prog, ctx, params, state = _start()
    params, state, _ = prog.step(params, state, _batch(0))
    spans.counters()
    # the direct count: the forward of the same params on the same batch
    drops = []
    real = TM.dispatch_indices

    def counting(experts, n, cap):
        slots, keep = real(experts, n, cap)
        drops.append((int((~keep).sum()), int(keep.numel())))
        return slots, keep
    TM.dispatch_indices = counting
    try:
        with torch.no_grad():
            TT.forward(params, local_batch(_batch(1), ctx, "cpu")["tokens"],
                       CFG, ctx, remat=False)
    finally:
        TM.dispatch_indices = real
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params, state, _ = prog.step(params, state, _batch(1))
        first = spans.counters()
        params, state, _ = prog.step(params, state, _batch(2))
    report = prog.report()
    prog.close()
    return {"events": _events(prof), "first": first,
            "second": report.get("counters", {}), "direct": drops,
            "n_params": sum(p.numel() for p in _leaves(params))}


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_span_nodes_only_under_the_profiler(on):
    """The loss's autograd graph holds span markers only while a profiler
    records; none with the profiler off."""
    _, ctx, params, _ = _start()
    for p in _leaves(params):
        p.requires_grad_(True)
    batch = local_batch(_batch(0), ctx, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) if on \
            else contextlib.nullcontext():
        loss = TT.lm_loss(params, batch, CFG, ctx, remat=True)
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    marked = [n for n in names if n.startswith(MARKERS)]
    assert (len(marked) > 0) == on
    assert len(names) > 50


@pytest.mark.parametrize("remat", [True, "dots", False])
def test_params_bit_identical_traced_and_untraced(remat):
    """3 steps with the profiler on and off end on the same parameters and
    moments, bit for bit."""
    out = []
    for on in (False, True):
        prog, _, params, state = _start(remat)
        with profile(activities=[ProfilerActivity.CPU]) if on \
                else contextlib.nullcontext():
            for k in range(3):
                params, state, _m = prog.step(params, state, _batch(k))
        prog.close()
        spans.counters()
        out.append(_leaves((params, state.mu, state.nu)))
    assert len(out[0]) == len(out[1]) > 10
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("region", REGIONS)
def test_backward_lies_in_the_forward_span(traced, region):
    """Every backward op whose forward op (same sequence number, run
    outside any backward) lies in ``region`` runs in ``region`` too, the
    markers' own nodes aside."""
    events = traced["events"]
    sp = _Spans(events)
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"
           and "Sequence number" in e.get("args", {})]
    bwd = [e for e in ops if e["name"].startswith(BWD)]
    windows = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in bwd]
    fwd = {}
    for e in sorted(ops, key=lambda e: float(e["ts"])):
        ts = float(e["ts"])
        if e["name"].startswith(BWD) or any(a <= ts <= b
                                            for a, b in windows):
            continue
        fwd.setdefault(e["args"]["Sequence number"], (e["tid"], ts))
    checked = 0
    for e in bwd:
        if any(m in e["name"] for m in MARKERS):
            continue
        at = fwd.get(e["args"]["Sequence number"])
        if at is None or sp.at(*at) != region:
            continue
        assert sp.at(e["tid"], float(e["ts"])) == region, e["name"]
        checked += 1
    assert checked >= 20


def test_one_step_span_a_step(traced):
    names = _Spans(traced["events"]).names()
    assert names.count("step") == 2
    assert names.count("adamw") == 2
    # forward, recompute and backward of each of the 2 layers
    assert names.count("attn") == 2 * 3 * 2


@pytest.mark.parametrize("counter", ["moe.assigned", "moe.dropped"])
def test_moe_counters_are_a_direct_count(traced, counter):
    """The first profiled step's counters equal a direct count from
    ``dispatch_indices`` on its inputs: once a layer, not doubled by the
    recompute; the second step's come through ``StepProgram.report``."""
    direct = traced["direct"]
    assert len(direct) == CFG.n_layers
    want = {"moe.dropped": sum(d for d, _ in direct),
            "moe.assigned": sum(n for _, n in direct)}
    assert want["moe.assigned"] == CFG.n_layers * BATCH * SEQ * 2
    assert want["moe.dropped"] > 0
    assert traced["first"][counter] == want[counter]
    # beside them the optimizer's and attention's, on their plain paths:
    # every parameter, and every query row x head once a layer (the
    # recompute counts nothing)
    assert set(traced["second"]) == set(want) | {"adamw.plain",
                                                 "attn.plain"}
    assert traced["second"]["adamw.plain"] == traced["n_params"]
    assert traced["second"]["attn.plain"] == (CFG.n_layers * BATCH * SEQ
                                              * CFG.n_heads)
    if counter == "moe.assigned":
        assert traced["second"][counter] == want[counter]


def test_lower_on_meta_arguments_under_the_profiler():
    """The dry-run's path: a fresh step on meta arguments runs with the
    profiler on, launches nothing and counts nothing."""
    prog, ctx, params, state = _start()
    with profile(activities=[ProfilerActivity.CPU]):
        lowered = prog.lower(*meta_like((params, state, _batch(0))))
    prog.close()
    assert lowered.argument_bytes > 0 and lowered.output_bytes > 0
    assert spans.counters() == {}


def test_span_is_off_without_a_profiler():
    """Off: the shared no-op, marking nothing and counting nothing."""
    x = torch.ones(3, requires_grad=True)
    with spans.span("attn", 1) as sp:
        assert sp.inputs(x) is x and sp.outputs(x, x) == (x, x)
    spans.count("moe.assigned", 4)
    assert spans.span("a") is spans.span("b")
    assert spans.counters() == {}


@pytest.fixture(scope="module")
def route_ranks(tmp_path_factory):
    pinned = str(tmp_path_factory.mktemp("spans") / "pinned.json")
    _torch_ranks.pinned_profile(pinned, "h100", 2,
                                {"nvlink": 50, "pcie": 25, "rdma": 25})
    return run_ranks(_torch_ranks.route_spans, 2, backend="gloo",
                     device="cpu", timeout_s=300, args=(pinned, 1 << 20))


@pytest.mark.parametrize("rank", [0, 1])
def test_route_span_bytes_are_the_segments(route_ranks, rank):
    """Each ``route.<path>`` span's argument is the bytes of that path's
    segment in the plan the call took (on 2 ranks primary and staged: no
    ortho ring), in the bucket's ``sync.bucket`` span; the result is the
    exact sum."""
    got = route_ranks[rank]
    routes = {n.split(".", 1)[1]: int(a) for n, a in got["ranges"]
              if n.startswith("route.")}
    assert routes == got["segments"]
    assert set(routes) == {"primary", "staged"}
    assert sum(routes.values()) == 1 << 20
    assert ("sync.bucket", "g0") in got["ranges"]
    n = (1 << 20) // 4
    np.testing.assert_array_equal(
        got["y"].view(np.float32), np.arange(n, dtype=np.float32) * 3)
