"""A run with the timed path broken underneath comes out not correct:
every fault a training cell can have, planted in the program's modules
on every rank (``bench/faults.py``), driven through the rest of a run at
a CPU size past the look for a card, and judged by the cell's limits."""

import pytest

from bench import run
from bench.drivers import train
from bench.tests._small import small_cell, small_files

CASES = [("mixtral-8x7b.train-1chip", 1, f)
         for f in ("unchanged", "half_batch", "grad_altered")]
CASES += [("mixtral-8x7b.train-1chip", 2, f)
          for f in ("unchanged", "half_batch", "no_exchange", "grad_altered")]


@pytest.mark.parametrize("cell,world,fault", CASES)
def test_fault_is_not_correct(cell, world, fault):
    spec = small_cell(cell, world=world, fault=fault)
    ranks = train.run_cell(spec)
    out = run.assemble(cell, small_files(spec), ranks, False, {})
    assert not out["correct"], out["checks"]
    failed = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failed


def test_faults_are_restored():
    from repro_torch.launch import steps
    from repro_torch.models import tp
    from repro_torch.train import train_step
    from bench import faults
    before = (train_step.apply_updates, steps.local_batch,
              tp.ParallelCtx.grad_all_reduce)
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert before == (train_step.apply_updates, steps.local_batch,
                      tp.ParallelCtx.grad_all_reduce)
