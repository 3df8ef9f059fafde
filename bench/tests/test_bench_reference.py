"""The plain reference against the program's train step at a CPU size:
on one rank and on gloo ranks, the program's checked steps come out
within the cell's limits, and the control (the reference on float8
operands) sits well apart from the program on the number that catches
it.  At this size every reading is smaller than at the cell's, the
control's too, so the control's verdict at the cell's limits is checked
at the cell's own size (``test_bench_card.py``)."""

import pytest

from bench import compare, run
from bench.drivers import train
from bench.tests._small import small_cell, small_files

#: the cell on its own one rank, and on two gloo ranks: the data-parallel
#: path (the reference's row blocks and all-reduce, the program's
#: gradient sync) held to the same limits
CELLS = [("mixtral-8x7b.train-1chip", 1), ("mixtral-8x7b.train-1chip", 2)]


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def sound(request):
    cell, world = request.param
    spec = small_cell(cell, world=world)
    return spec, train.run_cell(spec)


def test_program_agrees_with_the_reference(sound):
    spec, ranks = sound
    out = run.assemble(spec["cell"]["name"], small_files(spec), ranks,
                       False, {})
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    for r in ranks:
        # every rank trained the same global batch: the same losses
        assert r["prog"]["losses"] == ranks[0]["prog"]["losses"]
        assert r["numbers"]["loss_gap"]["value"] < 1e-3
        assert r["numbers"]["grad_diff_median"]["value"] < 0.05
    assert set(out["metrics"]) == {"train_tok_s", "setup_s"}


@pytest.mark.parametrize("cell,world", CELLS)
def test_control_is_apart_from_the_program(cell, world):
    spec = small_cell(cell, world=world)
    spec.update(seeds=[spec["seed"]], variant_seeds=[spec["seed"]],
                variants=["control"], faults=[])
    got = train.calibrate(spec)
    limits = spec["cell"]["limits"]
    verdict = {}
    for variant in ("program", "control"):
        readings = [{n: row["numbers"][n]["value"] for n in compare.NUMBERS}
                    for r in got for row in r["rows"]
                    if row["variant"] == variant]
        verdict[variant] = compare.checks(readings, limits)
    assert compare.passes(verdict["program"]), verdict["program"]
    prog = verdict["program"]["grad_diff_median"]["value"]
    ctrl = verdict["control"]["grad_diff_median"]["value"]
    assert ctrl >= 5 * prog, (prog, ctrl)
