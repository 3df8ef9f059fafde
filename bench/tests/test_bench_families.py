"""The family contract (``bench/reference/<family>.py``): the ``dense`` and
``moe`` modules lay out, draw and score exactly what the harness did
before families were modules, and a family that exists only in this test
runs a cell through the training driver and comes out correct."""

import hashlib
import json
import pathlib
import sys
import types

import pytest
import torch

from bench import cells, reference, run, traffic, weights
from bench.drivers import train
from bench.reference import model
from bench.tests._small import small_cell, small_files

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: every leaf of the two configuration files at their own sizes, as the
#: harness laid them out before the families were modules
SPECS = {
    "mixtral-8x7b": [
        ("embed", (32000, 4096), "normal"),
        ("final_norm", (4096,), "ones"),
        ("layers/attn/wk", (2, 4096, 1024), "normal"),
        ("layers/attn/wo", (2, 4096, 4096), "normal"),
        ("layers/attn/wq", (2, 4096, 4096), "normal"),
        ("layers/attn/wv", (2, 4096, 1024), "normal"),
        ("layers/ln1", (2, 4096), "ones"),
        ("layers/ln2", (2, 4096), "ones"),
        ("layers/moe/experts/w_down", (2, 8, 14336, 4096), "normal"),
        ("layers/moe/experts/w_gate", (2, 8, 4096, 14336), "normal"),
        ("layers/moe/experts/w_up", (2, 8, 4096, 14336), "normal"),
        ("layers/moe/w_router", (2, 4096, 8), "normal"),
        ("lm_head", (4096, 32000), "normal")],
    "glm4-9b": [
        ("embed", (151552, 4096), "normal"),
        ("final_norm", (4096,), "ones"),
        ("layers/attn/bk", (10, 256), "zeros"),
        ("layers/attn/bq", (10, 4096), "zeros"),
        ("layers/attn/bv", (10, 256), "zeros"),
        ("layers/attn/wk", (10, 4096, 256), "normal"),
        ("layers/attn/wo", (10, 4096, 4096), "normal"),
        ("layers/attn/wq", (10, 4096, 4096), "normal"),
        ("layers/attn/wv", (10, 4096, 256), "normal"),
        ("layers/ln1", (10, 4096), "ones"),
        ("layers/ln2", (10, 4096), "ones"),
        ("layers/mlp/w_down", (10, 13696, 4096), "normal"),
        ("layers/mlp/w_gate", (10, 4096, 13696), "normal"),
        ("layers/mlp/w_up", (10, 4096, 13696), "normal"),
        ("lm_head", (4096, 151552), "normal")],
}

#: at the CPU size of each config's cell, on the cut's seed: the digest of
#: the drawn leaves (each path, then its bfloat16 bits) and the reference
#: loss of pool batch 0, as the harness gave them before the families
#: were modules
DRAWN = {
    "mixtral-8x7b.train-1chip": (
        "fb54e649d25c5b504651ce902676029c414e727fff27bebb4fbcae403a32de38",
        5.5891900062561035),
    "glm4-9b.train-dp4": (
        "aeea47869f64b918e638871fe6744f82cb2b87326a015b125b44644de316f0b3",
        5.549391269683838),
}


def _config(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_layout_is_unchanged(name):
    got = [("/".join(p), tuple(s), k)
           for p, s, k in weights.leaf_specs(_config(name))]
    assert got == SPECS[name]


@pytest.mark.parametrize("cell", sorted(DRAWN))
def test_drawn_leaves_and_loss_are_unchanged(cell):
    spec = small_cell(cell, world=1)
    cfg = spec["config"]
    h = hashlib.sha256()
    for path, x in weights.leaves(cfg, spec["seed"], "cpu"):
        h.update("/".join(path).encode())
        h.update(x.contiguous().view(torch.int16).numpy().tobytes())
    tree = weights.nest((p, x.float()) for p, x in
                        weights.leaves(cfg, spec["seed"], "cpu"))
    pool = traffic.token_pool(spec["traffic"], cfg["vocab_size"],
                              spec["seed"], "cpu")
    b = traffic.batch(pool, 0)
    loss = reference.family(cfg).loss(tree, b["tokens"], b["labels"], cfg,
                                      torch.matmul)
    digest, want = DRAWN[cell]
    assert h.hexdigest() == digest
    assert float(loss) == pytest.approx(want, rel=1e-6)


def test_a_family_is_a_module_with_the_contract():
    with pytest.raises(ModuleNotFoundError):
        reference.family({"family": "no_such_family"})
    with pytest.raises(ValueError, match="lacks"):
        reference.family({"family": "adamw"})
    with pytest.raises(ValueError, match="module name"):
        reference.family({"family": "../model"})


# -- a family unknown to the harness, in this test alone ---------------------

#: the module name of the family below
NEW_FAMILY = "moe_dense_prefix"

#: the port's kimi-k2-1t-a32b (a dense prefix, ep_a2a experts) as a
#: configuration file would give it, under the model's own key names
KIMI = {"name": "kimi-k2-1t-a32b", "program_arch": "kimi-k2-1t-a32b",
        "family": NEW_FAMILY, "hidden_size": 7168, "num_hidden_layers": 61,
        "num_attention_heads": 64, "num_key_value_heads": 8,
        "head_dim": 112, "intermediate_size": 2048, "vocab_size": 163840,
        "rope_theta": 50000.0, "rms_norm_eps": 1e-05, "sliding_window": None,
        "attention_bias": False, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16", "n_routed_experts": 384,
        "num_experts_per_tok": 8, "first_k_dense_replace": 1,
        "capacity_factor": 1.25, "router_aux_loss_coef": 0.01}


def _new_family() -> types.ModuleType:
    """Leading dense blocks (``prefix``), then blocks of routed experts."""
    mod = types.ModuleType(f"bench.reference.{NEW_FAMILY}")
    mod.PROGRAM_KEYS = {"n_routed_experts": "moe.n_experts",
                        "first_k_dense_replace": "moe.n_dense_prefix"}

    def leaf_specs(cfg):
        d, f = cfg["hidden_size"], cfg["intermediate_size"]
        pre = cfg["first_k_dense_replace"]
        rest = cfg["num_hidden_layers"] - pre
        return sorted(model.outer_specs(cfg)
                      + model.attention_specs("prefix", pre, cfg)
                      + model.mlp_specs("prefix", pre, d, f)
                      + model.attention_specs("layers", rest, cfg)
                      + model.moe_specs("layers", rest, d, f,
                                        cfg["n_routed_experts"]))

    def loss(params, tokens, labels, cfg, mm=torch.matmul):
        nll, aux = model.nll_and_aux(params, tokens, labels, cfg, mm,
                                     stacks=("prefix", "layers"))
        return nll + cfg["router_aux_loss_coef"] * aux

    def small(cfg):
        return dict(cfg, **dict(model.SMALL, num_hidden_layers=3),
                    n_routed_experts=4, num_experts_per_tok=2)

    mod.leaf_specs, mod.loss, mod.small = leaf_specs, loss, small
    return mod


@pytest.fixture
def new_family(monkeypatch):
    monkeypatch.setitem(sys.modules, f"bench.reference.{NEW_FAMILY}",
                        _new_family())


def test_new_family_keys_and_tree_are_the_programs(new_family):
    from repro_torch.launch.steps import eval_shape_params
    arch = cells.program_config(KIMI)
    assert (arch.moe.n_experts, arch.moe.n_dense_prefix, arch.moe.top_k,
            arch.moe.impl, arch.moe.aux_loss_weight) == (384, 1, 8, "ep_a2a",
                                                         0.01)
    assert (arch.n_layers, arch.d_ff, arch.head_dim_) == (61, 2048, 112)
    want = {p: tuple(x.shape) for p, x in
            weights.flatten(eval_shape_params(arch))}
    got = {p: s for p, s, _ in weights.leaf_specs(KIMI)}
    assert got == want


def test_new_family_runs_a_cell_correct(new_family):
    spec = small_cell("mixtral-8x7b.train-1chip")
    spec["config"] = reference.family(KIMI).small(KIMI)
    spec["cell"] = dict(spec["cell"], name="kimi-k2-1t-a32b.train-1chip",
                        config=KIMI["name"])
    ranks = train.run_cell(spec)
    out = run.assemble(spec["cell"]["name"], small_files(spec), ranks,
                       False, {})
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    leaves = ranks[0]["numbers"]["grad_norm_gap"]["leaves"]
    assert {"prefix/mlp/w_down", "layers/moe/experts/w_down"} <= set(leaves)
    assert set(out["metrics"]) == {"train_tok_s", "setup_s"}
