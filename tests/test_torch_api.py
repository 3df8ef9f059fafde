"""The port's last API leftovers against the JAX reference, on the same
inputs:

* ``Checkpointer.restore_latest``: one snapshot directory written by each
  package, restored by both (params bit for bit, the same opt state, meta
  and step), and FileNotFoundError on an empty directory;
* ``layers.lse_merge`` on seeded partials, a shard whose ``m`` is all
  -inf and rows that no shard saw included, within 1e-6 in float32;
* ``ParallelCtx.observe_executed_step`` and ``reset_issued`` on a
  single-device ctx and on a 2-rank gloo ctx (the port's ranks spawned
  once): the same return values and replay-log lengths after each call
  (compare tests/test_routing.py ``test_ctx_reset_issued_clears_all_comms``);
* the ``collectives.flex_*`` re-exports are routing's objects, and the
  package ``__init__``s export the reference's names (``param_specs`` and
  ``core.collectives`` among them), ``param_specs`` equal to the
  reference's;
* ``configs.flexlink_h800.CONFIG`` equal to the reference's field by field.
"""

import ast
import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.checkpoint.checkpointer import Checkpointer as JCkpt
from repro.configs import get_config as j_get_config
from repro.core import communicator as j_comm
from repro.core.topology import Collective as JColl
from repro.models import layers as JL
from repro.models.tp import ParallelCtx as JCtx
from repro.models.tp import single_device_ctx as j_single
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint.checkpointer import Checkpointer as TCkpt
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import layers as TL
from repro_torch.models.tp import single_device_ctx as t_single
from repro_torch.optim import adamw as t_adamw
from test_torch_moe import t_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMM = {"profile": "h800", "measurement_noise": 0.05, "seed": 3}
MiB = 1 << 20
#: (op, float32 elements) planned on every communicator, then observed
CALLS = [(op, n // 4) for n in (4 * 1024, 3 * MiB, 64 * MiB)
         for op in ("all_reduce", "all_gather", "reduce_scatter")]
OBSERVES = 30


# ---------------------------------------------------------------------------
# Checkpointer.restore_latest
# ---------------------------------------------------------------------------

def _params_np(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 8, 8)).astype(
                np.float32), "ln1": rng.standard_normal((2, 8)).astype(
                    np.float32)}}


def _ref_tree(p):
    """The reference's params (``wq`` in bfloat16) and AdamW state."""
    params = jax.tree.map(jnp.asarray, p)
    params["layers"]["wq"] = params["layers"]["wq"].astype(jnp.bfloat16)
    return params, j_adamw.init_state(params)


def _port_tree(p):
    params = jax.tree.map(torch.from_numpy, p)
    params["layers"]["wq"] = params["layers"]["wq"].to(torch.bfloat16)
    return params, t_adamw.init_state(params)


def _np_leaves(tree, prefix=""):
    """{"a/b": float32 numpy} of a tree of jax arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_np_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _restored(which, directory):
    """``restore_latest`` of ``which`` package from ``directory``: (params
    leaves, opt moment leaves, opt step, meta, step)."""
    p = _params_np(0)
    if which == "ref":
        params, opt = _ref_tree(p)
        got = JCkpt(directory).restore_latest(params, opt)
    else:
        params, opt = _port_tree(p)
        got = TCkpt(directory).restore_latest(params, opt)
    params, opt, meta, step = got
    return (_np_leaves(params),
            {**_np_leaves(opt.mu, "mu/"), **_np_leaves(opt.nu, "nu/")},
            int(opt.step), meta, step)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_restore_latest_matches_reference(writer, tmp_path):
    """Snapshots at steps 3, 7 and 11 (keep 2) from ``writer``'s package;
    both packages restore the newest, step 11, alike and bit for bit."""
    for step in (3, 7, 11):
        p = _params_np(step)
        if writer == "ref":
            params, opt = _ref_tree(p)
            opt = opt._replace(step=jnp.asarray(step, jnp.int32))
            JCkpt(str(tmp_path), keep=2).save(step, params, opt,
                                              extra={"w": writer})
        else:
            params, opt = _port_tree(p)
            opt = opt._replace(step=torch.tensor(step, dtype=torch.int32))
            TCkpt(str(tmp_path), keep=2).save(step, params, opt,
                                              extra={"w": writer})
    ref = _restored("ref", str(tmp_path))
    port = _restored("port", str(tmp_path))
    want = _np_leaves(_port_tree(_params_np(11))[0])
    for got in (ref, port):
        assert got[0].keys() == want.keys()
        for k, w in want.items():
            assert got[0][k].tobytes() == w.tobytes(), k
    assert port[1].keys() == ref[1].keys()
    for k in ref[1]:
        assert port[1][k].tobytes() == ref[1][k].tobytes(), k
    assert port[2] == ref[2] == 11
    assert port[3] == ref[3] == {"step": 11, "extra": {"w": writer}}
    assert port[4] == ref[4] == 11


@pytest.mark.parametrize("which", ["ref", "port"])
def test_restore_latest_raises_on_empty_directory(which, tmp_path):
    with pytest.raises(FileNotFoundError):
        _restored(which, str(tmp_path))


# ---------------------------------------------------------------------------
# lse_merge
# ---------------------------------------------------------------------------

def _partials(seed, n_shards, dead):
    """Seeded (acc [B,Hkv,g,Sq,hd], m, l [B,Hkv,g,Sq]) partials, float32;
    shard ``dead`` has m = -inf everywhere (it saw no key), and in every
    shard the last query row has m = -inf (no shard saw a key for it)."""
    rng = np.random.default_rng(seed)
    b, hkv, g, sq, hd = 2, 2, 3, 4, 8
    parts = []
    for i in range(n_shards):
        m = rng.standard_normal((b, hkv, g, sq)).astype(np.float32) * 4
        l = rng.uniform(0.5, 3.0, (b, hkv, g, sq)).astype(np.float32)
        acc = rng.standard_normal((b, hkv, g, sq, hd)).astype(np.float32)
        m[..., -1] = -np.inf
        l[..., -1] = 0.0
        acc[..., -1, :] = 0.0
        if i == dead:
            m[:] = -np.inf
            l[:] = 0.0
            acc[:] = 0.0
        parts.append((acc, m, l))
    return parts


@pytest.mark.parametrize("n_shards,dead", [(2, None), (3, 1), (4, 0)])
def test_lse_merge_matches_reference(n_shards, dead):
    parts = _partials(n_shards, n_shards, dead)
    want = np.asarray(JL.lse_merge([tuple(jnp.asarray(a) for a in p)
                                    for p in parts]))
    got = TL.lse_merge([tuple(torch.from_numpy(a) for a in p)
                        for p in parts]).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the rows no shard saw merge to exact zeros
    assert not np.any(got[..., -1, :])


# ---------------------------------------------------------------------------
# ParallelCtx.observe_executed_step / reset_issued
# ---------------------------------------------------------------------------

def _j_plan(comm, op, n):
    comm.plan_for(JColl(op), jax.ShapeDtypeStruct((n,), jnp.float32))


@pytest.fixture(scope="module")
def ctx_ranks():
    """The port's 2-rank gloo ctx, spawned once."""
    return run_ranks(_torch_ranks.ctx_replay, 2, backend="gloo",
                     device="cpu", timeout_s=300,
                     args=(COMM, CALLS, OBSERVES))


def test_ctx_replay_hooks_on_one_device():
    """No communicator: nothing to observe or clear, in both packages."""
    for ctx in (j_single(), t_single()):
        assert ctx.comms() == ()
        assert ctx.observe_executed_step() is False
        assert ctx.reset_issued() is None


def test_ctx_replay_hooks_match_reference_on_two_ranks(ctx_ranks):
    j_comm.comm_destroy_all()
    ctx = JCtx(dp_axis="data", dp_size=2,
               comm_config=j_comm.CommConfig(**COMM))
    want = _torch_ranks.ctx_trace(ctx, _j_plan, CALLS, OBSERVES)
    j_comm.comm_destroy_all()
    assert len(ctx.comms()) == 1
    assert want[0][2] == [len(CALLS)] and want[-1][2] == [0]
    assert any(changed for _, changed, _ in want[1:-1])
    for got in ctx_ranks:
        assert got == want


# ---------------------------------------------------------------------------
# re-exports, param_specs, the H800 config
# ---------------------------------------------------------------------------

ROUTED = ("flex_all_reduce", "flex_all_gather", "flex_reduce_scatter",
          "flex_all_to_all", "RoutePlan", "build_plan", "execute")


@pytest.mark.parametrize("name", ROUTED)
def test_collectives_reexport_routing(name):
    from repro.core import collectives as jc
    from repro.core import routing as jr
    from repro_torch.core import collectives as tc
    from repro_torch.core import routing as tr
    assert getattr(jc, name) is getattr(jr, name)
    assert getattr(tc, name) is getattr(tr, name)
    assert tc._ROUTED == jc._ROUTED == ROUTED
    with pytest.raises(AttributeError):
        getattr(tc, "flex_nothing")


#: the reference's packages (compat/ needs no port: every rank is a
#: process)
PACKAGES = sorted(p.parent.name for p in (ROOT / "src" / "repro").glob(
    "*/__init__.py") if p.parent.name != "compat")


def _exported(pkg):
    """The names the reference package's ``__init__`` imports, and those
    it re-exports lazily."""
    mod = importlib.import_module(f"repro.{pkg}")
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    return names | set(getattr(mod, "_COMMUNICATOR_NAMES", ()))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_match_reference(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = sorted(n for n in _exported(pkg) if not hasattr(port, n))
    assert not missing


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_param_specs_export_matches_reference(arch):
    from repro.models import param_specs as j_specs
    from repro_torch.models import param_specs as t_specs
    from repro_torch.models.transformer import param_specs
    assert t_specs is param_specs
    cfg = j_get_config(arch).reduced()
    want = jax.tree.map(lambda s: tuple(s), j_specs(cfg),
                        is_leaf=lambda s: isinstance(s, jax.sharding.
                                                     PartitionSpec))
    got = t_specs(t_config(cfg))

    def norm(spec):
        spec = tuple(spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec

    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, tuple))[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda s: isinstance(s, tuple))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert [norm(s) for _, s in flat_g] == [norm(s) for _, s in flat_w]


def test_flexlink_h800_config_matches_reference():
    from repro.configs import flexlink_h800 as J
    from repro_torch.configs import flexlink_h800 as T
    j, t = J.CONFIG, T.CONFIG
    names = [f.name for f in dataclasses.fields(j)]
    assert names == [f.name for f in dataclasses.fields(t)]
    for name in names:
        jv, tv = getattr(j, name), getattr(t, name)
        if name == "collectives":
            assert [c.value for c in tv] == [c.value for c in jv]
        elif name == "comm":
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, name
    assert T.BandwidthEvalConfig() == t
