"""``bench/flops/`` against counts made by hand from the published
widths, and the MFU reader on them."""

import json
import pathlib

import pytest

from bench.flops import dense, moe
from bench.metrics import step_mfu_pct

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def test_glm4_9b_by_hand():
    cfg = _cfg("glm4-9b")
    # a layer: Q and O 4096 x 4096 each, K and V 4096 x (2 x 128) each,
    # the MLP 3 x 4096 x 13696
    layer = 2 * 16_777_216 + 2 * 1_048_576 + 168_296_448
    assert layer == 203_948_032
    head = 4096 * 151_552
    assert dense.matmul_params(cfg) == 10 * layer + head == 2_660_237_312
    # causal pairs of 4096 tokens, 2 x 2 x 128 x 32 FLOPs a pair for QK^T
    # and PV, x3 forward and backward, 10 layers, 4 sequences
    attn = 3 * (4096 * 4097 // 2) * 16_384 * 10 * 4
    assert dense.step_flops(cfg, 4096, 4) == pytest.approx(
        6 * 2_660_237_312 * 4 * 4096 + attn, rel=1e-12)


def test_mixtral_8x7b_by_hand():
    cfg = _cfg("mixtral-8x7b")
    # attention 2 x 4096^2 + 2 x 4096 x 1024, router 4096 x 8, two of the
    # eight experts of 3 x 4096 x 14336
    layer = 41_943_040 + 32_768 + 2 * 176_160_768
    assert moe.matmul_params(cfg) == 2 * layer + 4096 * 32_000 \
        == 919_666_688
    attn = 3 * (4096 * 4097 // 2) * 16_384 * 2
    assert moe.step_flops(cfg, 4096, 1) == pytest.approx(
        6 * 919_666_688 * 4096 + attn, rel=1e-12)


def test_window_reaches_the_window_only_when_shorter_than_the_sequence():
    from bench.flops.common import attended_pairs
    assert attended_pairs(8, None) == attended_pairs(8, 8) == 36
    assert attended_pairs(8, 3) == 6 + 5 * 3


def test_mfu_of_a_run():
    files = {"config": _cfg("mixtral-8x7b"),
             "traffic": {"ranks": 1, "batch_per_rank": 1, "seq_len": 4096}}
    flops = moe.step_flops(files["config"], 4096, 1)
    run = {"files": files, "chips": 1, "peaks": {"bf16_flops_per_s": 1e15},
           "ranks": [{"steps": 10, "window_s": 2.0}]}
    assert step_mfu_pct.read(run) == pytest.approx(100 * flops * 10 / 2e15)
    assert step_mfu_pct.read(dict(run, peaks={})) is None
