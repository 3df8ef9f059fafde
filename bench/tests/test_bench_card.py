"""On a card: one short run of each one-card cell through the command,
``correct`` true, the result's keys and device; and the control at the
cell's own size, judged by the harness's comparison at the cell's limits,
comes out not correct where the program comes out correct.  Skips
without a card."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE_CARD = [w["name"] for w in MANIFEST["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_one_card_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["device"]["kind"] == card
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_is_not_correct_at_the_cell_size(card, cell):
    seed = str(2 ** 31 + 103)
    out = subprocess.run(
        [sys.executable, "bench/calibrate.py", "--workload", cell,
         "--seeds", seed, "--variant-seeds", seed, "--variants", "control"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{"seed"')]
    assert {r["variant"]: r["correct"] for r in rows} == {
        "program": True, "control": False}, rows
