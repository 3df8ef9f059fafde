"""The numbers that decide ``correct``, from what the program's first
training steps left and what the reference computed, and the comparison
of each with its limit.

* ``grad_norm_gap``: over the leaves, the largest gap between the norm of
  the program's step-1 gradient, as its optimizer got it, and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
* ``grad_diff_median``: the median over the leaves of the distance
  between the program's step-1 gradient and the reference's, over the
  reference's norm, leaving out leaves nought to rounding: the one number
  that is first-order in the rounding error (the gaps of norms are
  second-order in a random error);
* ``change_norm_gap``: the same as ``grad_norm_gap`` for the norm of each
  leaf's change after the checked steps, leaving out leaves whose
  reference gradient is under a thousandth of the median leaf's
  (round-off moves them under Adam).

``loss_gap``, the largest relative gap of a step's loss, is a reading
printed beside them and compared with nothing: neither the control nor a
fault moves it far from the program's.

The program's gradient is worked out from its optimizer state after step
1: AdamW's first moment is then ``(1 - beta1) * scale * g``, with ``scale``
the clipping factor of the gradient norm the step reported.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Tuple

import torch

from bench.reference.train import name, norm

#: a leaf's reference gradient under this share of the median leaf's
#: counts as nought to rounding
NOUGHT = 1e-3

#: the numbers compared with a limit, each cell's ``limits`` in its file
NUMBERS = ("grad_norm_gap", "grad_diff_median", "change_norm_gap")


def leaf_norms(pairs: Iterable) -> Dict[str, float]:
    return {name(path): norm(x) for path, x in pairs}


def optimizer_grad_norms(mu_norms: Dict[str, float], grad_norm: float,
                         opt: Dict) -> Dict[str, float]:
    """Per-leaf gradient norms from the first moment's after one step."""
    scale = min(1.0, opt["grad_clip"] / (grad_norm + 1e-9))
    return {k: v / ((1 - opt["beta1"]) * scale) for k, v in mu_norms.items()}


def host_grads(mu_pairs: Iterable, grad_norm: float, opt: Dict,
               dtype) -> Dict[str, torch.Tensor]:
    """The step-1 gradient as the optimizer got it, by leaf, on the host
    in the parameters' type: exact for a gradient of that type, since the
    first moment is a float32 multiple of it."""
    scale = min(1.0, opt["grad_clip"] / (grad_norm + 1e-9))
    return {name(path): (m / ((1 - opt["beta1"]) * scale)).to(dtype).cpu()
            for path, m in mu_pairs}


def grad_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               device) -> Dict[str, float]:
    """Per leaf, the distance of ``prog`` from ``ref`` over the norm of
    ``ref``, leaf by leaf on ``device`` (either side may be on the
    host)."""
    out = {}
    for k, r in ref.items():
        r = r.to(device).float()
        out[k] = norm(prog[k].to(device).float() - r) / max(norm(r), 1e-30)
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip=()) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm
    and the median leaf's (a leaf the program lacks reads NaN)."""
    keep = [k for k in ref if k not in skip]
    floor = statistics.median(ref[k] for k in keep)
    return {k: abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor)
            for k in keep}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """The largest gap and its leaf; NaN wins."""
    k = max(gaps, key=lambda k: (math.isnan(gaps[k]),
                                 0.0 if math.isnan(gaps[k]) else gaps[k]))
    return gaps[k], k


def median(gaps: Dict[str, float]) -> float:
    vals = list(gaps.values())
    return math.nan if any(math.isnan(v) for v in vals) \
        else statistics.median(vals)


def numbers(prog: Dict, ref: Dict, diffs: Dict[str, float]
            ) -> Dict[str, Dict]:
    """Each number with the leaf or step it was worst at; ``diffs`` are
    ``grad_diffs`` of the run against the reference."""
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        steps.append(math.nan)
    i = max(range(len(steps)),
            key=lambda j: (math.isnan(steps[j]), 0.0 if math.isnan(steps[j])
                           else steps[j]))
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    nought = {k for k, v in grads.items() if v < NOUGHT * med}
    gg = leaf_gaps(prog["grad_norms"], grads)
    cg = leaf_gaps(prog["change_norms"], ref["change_norms"], nought)
    g, g_at = worst(gg)
    c, c_at = worst(cg)
    return {"loss_gap": {"value": steps[i], "at": f"step {i + 1}"},
            "grad_norm_gap": {"value": g, "at": g_at, "leaves": gg},
            "grad_diff_median": {"value": median(
                {k: v for k, v in diffs.items() if k not in nought}),
                "leaves": diffs},
            "change_norm_gap": {"value": c, "at": c_at, "leaves": cg}}


def checks(readings: Iterable[Dict[str, float]], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """Each compared number, the worst of ``readings`` (one a rank,
    number -> value; NaN wins), beside its limit."""
    readings = list(readings)
    return {n: {"value": worst(dict(enumerate(r[n] for r in readings)))[0],
                "limit": limits[n]} for n in NUMBERS}


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit (NaN never is)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
