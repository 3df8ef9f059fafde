"""The port's roofline (``src/repro_torch/roofline/``) against the
reference's: the analytic cost model and the step-time bounds float for
float, the parameter and model-FLOP counts, and the summary of a lowered
step's logged collectives.  The hardware constants are the H100's, so
only the hardware-free quantities are compared; the ``t_*`` terms are
checked against the card's datasheet peaks."""

import dataclasses
import pathlib
import re

import pytest

from repro.configs import ALIASES as J_ALIASES
from repro.configs import get_config as j_get
from repro.launch import shapes as JSH
from repro.roofline import analysis as JA
from repro.roofline import analytic as JM
from repro_torch.configs import get_config as t_get
from repro_torch.launch import shapes as TSH
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import analytic as TM
from repro_torch.roofline.analytic import step_time_bounds

ARCHS = sorted(J_ALIASES)
SHAPES = sorted(JSH.SHAPES)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _shapes(name):
    return JSH.SHAPES[name], TSH.SHAPES[name]


def _asdict(cost):
    d = dataclasses.asdict(cost)
    d["colls"] = [dataclasses.astuple(c) for c in cost.colls]
    return d


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_reference(arch, shape):
    """Every field of the CostBreakdown at the production (tp, dp) = (16,
    16), float for float, and its collective totals by axis and op."""
    js, ts = _shapes(shape)
    want = JM.cost_model(j_get(arch), js, tp=16, dp=16)
    got = TM.cost_model(t_get(arch), ts, tp=16, dp=16)
    assert _asdict(got) == _asdict(want)
    assert got.collective_bytes == want.collective_bytes
    assert got.coll_by_axis() == want.coll_by_axis()
    assert got.coll_by_op() == want.coll_by_op()


@pytest.mark.parametrize("kw", [
    {"remat": False}, {"remat": "dots"}, {"pods": 2},
    {"pods": 2, "ep_over_pods": True}, {"tp": 4, "dp": 2},
    {"backend": "nccl"}])
@pytest.mark.parametrize("arch", ["glm4-9b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b", "whisper-medium"])
def test_cost_model_options_equal_reference(arch, kw):
    kw = {"tp": 16, "dp": 16, **kw}
    js, ts = _shapes("train_4k")
    assert _asdict(TM.cost_model(t_get(arch), ts, **kw)) == \
        _asdict(JM.cost_model(j_get(arch), js, **kw))


def test_step_time_bounds_bracket_and_degenerate():
    """tests/test_overlap.py:355-372 on the port's copy."""
    b1 = step_time_bounds(1.0, 0.5, 0.8, n_buckets=1)
    assert b1["t_step_overlap"] == b1["t_step_serial"] == 1.8
    b8 = step_time_bounds(1.0, 0.5, 0.8, n_buckets=8)
    assert b8["t_step_serial"] == b1["t_step_serial"]
    assert b8["t_step_overlap"] < b1["t_step_serial"]
    assert b8["t_step_overlap"] >= max(1.0, 0.8)
    assert b8["exposed_comm_s"] == pytest.approx(0.1)
    bc = step_time_bounds(0.1, 0.1, 1.0, n_buckets=4)
    assert bc["t_step_overlap"] >= 1.0
    bm = step_time_bounds(0.2, 2.0, 0.5, n_buckets=4)
    assert bm["t_step_overlap"] == pytest.approx(
        max(2.0, 0.5 * 3 / 4) + 0.5 / 4)


@pytest.mark.parametrize("args,kw", [
    ((1.0, 0.5, 0.8), {"n_buckets": 1}),
    ((1.0, 0.5, 0.8), {"n_buckets": 8}),
    ((0.1, 0.1, 1.0), {"n_buckets": 4, "wire_scale": 0.53}),
    ((3e-3, 7e-4, 2.2e-3), {"n_buckets": 0}),
    ((0.2, 2.0, 0.5), {"n_buckets": 47, "wire_scale": 1.0})])
def test_step_time_bounds_equal_reference(args, kw):
    assert step_time_bounds(*args, **kw) == JM.step_time_bounds(*args, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_model_flop_counts_equal_reference(arch):
    jc, tc = j_get(arch), t_get(arch)
    for active in (False, True):
        assert TA.count_params(tc, active) == JA.count_params(jc, active)
        assert TM.param_count(tc, active) == JM.param_count(jc, active)
    for name in SHAPES:
        js, ts = _shapes(name)
        assert TA.model_flops_estimate(tc, ts) == \
            JA.model_flops_estimate(jc, js)


def test_collective_stats_summarise_a_mesh_log():
    """parse_collectives' job on a dry mesh's log: one CollectiveStats a
    call, its op, axis and operand bytes."""
    import torch
    mesh = Mesh.dry((2, 4), ("data", "model"))
    x = torch.empty((16, 8), dtype=torch.bfloat16, device="meta")
    mesh.all_reduce(x, "model")
    mesh.all_gather(x[:2], "data")
    mesh.permute([x, x.float()], "model", 1, 3)
    got = TA.collective_stats(mesh.log.traced)
    assert got == [TA.CollectiveStats("all_reduce", 256.0, "model"),
                   TA.CollectiveStats("all_gather", 32.0, "data"),
                   TA.CollectiveStats("collective_permute", 256.0, "model"),
                   TA.CollectiveStats("collective_permute", 512.0, "model")]
    assert {c.op for c in got} <= set(TA.COLLECTIVE_OPS)
    assert [(f.name, f.type) for f in dataclasses.fields(
        TA.CollectiveStats)] == [(f.name, f.type) for f in
                                 dataclasses.fields(JA.CollectiveStats)]


def test_roofline_terms_use_the_h100_datasheet_peaks():
    """The Roofline's hardware-free fields are the reference's; its time
    terms divide by the H100 SXM5's peaks."""
    kw = dict(arch="glm4-9b", shape="train_4k", mesh="single", chips=256,
              flops=3.1e18, hbm_bytes=8.2e14, collective_bytes_total=7.7e12,
              collective_by_axis={"model": 7.7e12},
              collective_by_op={"all_reduce": 7.7e12}, model_flops=2.4e18,
              memory_per_chip=2.0e9)
    got, want = TA.Roofline(**kw).to_dict(), JA.Roofline(**kw).to_dict()
    for k in kw:
        assert got[k] == want[k]
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    assert got["t_compute"] == 3.1e18 / (256 * 989e12)
    assert got["t_memory"] == 8.2e14 / (256 * 3.35e12)
    assert got["t_collective"] == 7.7e12 / (256 * 450e9)
    assert got["dominant"] == "compute"
    assert "H100" in TA.DEVICE and "700 W" in TA.DEVICE


def test_no_tpu_peak_in_the_roofline():
    """The reference's roofline peaks (a TPU's) are not carried into the
    port's roofline, its dry-run, its README section or PERF.md: a
    roofline at another chip's peaks would say nothing about the card.
    (The copied link-profile library, ``core/links.py``, keeps its
    ``tpu_v5e`` fabric profile: the tuner's parity runs use it.)"""
    figures = re.compile(r"\b(197e12|819e9|50e9)\b|197 TFLOP|819 GB/s")
    port = ROOT / "src" / "repro_torch"
    texts = [p.read_text() for p in (port / "roofline").glob("*.py")]
    texts += [(port / "launch" / "dryrun.py").read_text(),
              (ROOT / "PERF.md").read_text()]
    readme = (ROOT / "README.md").read_text()
    texts.append(readme[readme.find("repro_torch"):])
    for text in texts:
        assert not figures.search(text), figures.search(text)
