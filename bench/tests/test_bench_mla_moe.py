"""The ``mla_moe`` family (``bench/reference/mla_moe.py``) and its cell,
``kimi-k2-instruct.train-1chip``: the layout leaf by leaf at the file's
sizes, the cell through the training driver at a CPU size, and
``flops/mla_moe.py`` against a count by hand."""

import json
import math
import pathlib

import pytest

from bench import run, weights
from bench.drivers import train
from bench.flops import mla_moe
from bench.tests._small import small_cell, small_files

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "kimi-k2-instruct.train-1chip"


def _cfg():
    return json.loads((ROOT / "bench" / "configs" / "kimi-k2-instruct.json")
                      .read_text())


def _mla(stack, n):
    return [(f"{stack}/attn/kv_norm", (n, 512), "ones"),
            (f"{stack}/attn/q_norm", (n, 1536), "ones"),
            (f"{stack}/attn/wkv_a", (n, 7168, 576), "normal"),
            (f"{stack}/attn/wkv_b", (n, 512, 16384), "normal"),
            (f"{stack}/attn/wo", (n, 8192, 7168), "normal"),
            (f"{stack}/attn/wq_a", (n, 7168, 1536), "normal"),
            (f"{stack}/attn/wq_b", (n, 1536, 12288), "normal"),
            (f"{stack}/ln1", (n, 7168), "ones"),
            (f"{stack}/ln2", (n, 7168), "ones")]


#: every leaf at the file's sizes: MLA's q path 7168 -> 1536 -> 64 x 192
#: and kv path 7168 -> 512 + 64 -> 64 x (128 + 128), the dense layer's FFN
#: of 18432, 8 held experts of 2048 under a router over 384, one shared
#: expert, a vocabulary of 20480
SPECS = ([("embed", (20480, 7168), "normal"),
          ("final_norm", (7168,), "ones")]
         + _mla("layers", 4)
         + [("layers/moe/experts/w_down", (4, 8, 2048, 7168), "normal"),
            ("layers/moe/experts/w_gate", (4, 8, 7168, 2048), "normal"),
            ("layers/moe/experts/w_up", (4, 8, 7168, 2048), "normal"),
            ("layers/moe/router_bias", (4, 384), "zeros"),
            ("layers/moe/shared/w_down", (4, 2048, 7168), "normal"),
            ("layers/moe/shared/w_gate", (4, 7168, 2048), "normal"),
            ("layers/moe/shared/w_up", (4, 7168, 2048), "normal"),
            ("layers/moe/w_router", (4, 7168, 384), "normal"),
            ("lm_head", (7168, 20480), "normal")]
         + _mla("prefix", 1)
         + [("prefix/mlp/w_down", (1, 18432, 7168), "normal"),
            ("prefix/mlp/w_gate", (1, 7168, 18432), "normal"),
            ("prefix/mlp/w_up", (1, 7168, 18432), "normal")])


def test_layout_at_the_files_sizes():
    got = [("/".join(p), tuple(s), k) for p, s, k in
           weights.leaf_specs(_cfg())]
    assert got == SPECS
    assert sum(math.prod(s) for _, s, _ in SPECS) == 2_792_120_832


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_at_the_cpu_size(trace):
    spec = small_cell(CELL, trace=trace)
    ranks = train.run_cell(spec)
    out = run.assemble(CELL, small_files(spec), ranks, trace, {})
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    leaves = ranks[0]["numbers"]["grad_norm_gap"]["leaves"]
    assert {"prefix/mlp/w_down", "layers/attn/wkv_b",
            "layers/moe/shared/w_down", "layers/moe/router_bias"} <= \
        set(leaves)
    # the bias has a zero gradient, so AdamW leaves it at its zeros
    for side in ("prog", "ref"):
        assert ranks[0][side]["change_norms"]["layers/moe/router_bias"] == 0
    if trace:
        assert set(out["metrics"]) == {"mla_core_ms", "mla_latent_ms",
                                       "moe_shared_ms"}
        counters = ranks[0]["program_report"]["counters"]
        assert 0 < counters["moe.assigned"]
    else:
        assert set(out["metrics"]) == {"train_tok_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "grad_altered"])
def test_fault_is_not_correct_at_the_cells_limits(fault):
    spec = small_cell(CELL, fault=fault)
    out = run.assemble(CELL, small_files(spec), train.run_cell(spec), False,
                       {})
    assert not out["correct"], out["checks"]


def test_flops_by_hand():
    cfg = _cfg()
    # MLA: 7168 x 1536, 1536 x 64 x 192, 7168 x 576, 512 x 64 x 256,
    # 64 x 128 x 7168
    mla = 11_010_048 + 18_874_368 + 4_128_768 + 8_388_608 + 58_720_256
    assert mla_moe.mla_params(cfg) == mla == 101_122_048
    # an expert layer: the router 7168 x 384, the shared expert and 8 of a
    # token's routed experts times the 8 of 384 held, each 3 x 7168 x 2048
    expert = 3 * 7168 * 2048
    moe = 7168 * 384 + expert + expert * 8 * 8 // 384
    assert moe == 54_132_736
    total = 5 * mla + 3 * 7168 * 18432 + 4 * moe + 7168 * 20480
    assert mla_moe.matmul_params(cfg) == total == 1_265_303_552
    # causal pairs of 4096 tokens, 2 x 64 x (192 + 128) FLOPs a pair, x3,
    # 5 layers, one sequence
    attn = 3 * (4096 * 4097 // 2) * 40_960 * 5
    assert mla_moe.step_flops(cfg, 4096, 1) == pytest.approx(
        6 * total * 4096 + attn, rel=1e-12)
