"""The port's tensor-parallel train step against the JAX reference.

Reduced glm4-9b (2 layers, d_model 256, float32) on a (data=2, model=4)
mesh, from the reference's ``init_params`` (through numpy and
``convert.shard_params``) and ``make_batches(seed=7)``, AdamW at the
reference's test settings (tests/test_integration.py:37-48).  The port
runs on 8 gloo ranks spawned once (rank side in ``_torch_ranks.py``), the
reference's jitted ``shard_map`` step on the conftest's 8 CPU devices.
Both packages use the degraded ``h800!nvlink=0.1`` profile and a
TuningProfile that pins the model axis's all-reduce slot to primary 50 /
staged 25 / ortho 25, so every row-parallel combine, forward and
transposed, crosses three routes.

What the reference computes under ``check_vma=False`` is held exactly as
it is: sharded leaves get tp times their gradient, each model rank keeps
its own copy of every replicated leaf (they drift apart), and the
collectives are recorded once per trace.  Checked:

* one ``lm_loss`` gradient on (model=4), leaf by leaf and rank by rank;
* 3 steps of nccl and flexlink: per-step losses within 5e-3 of the
  reference and of each other, equal on every rank;
* the state after 3 steps: every rank's shard of every sharded leaf and
  every model rank's copy of every replicated leaf, params and both AdamW
  moments, against the reference's ``addressable_shards``;
* what the communicators recorded after one step (3 model-axis and 12
  data-axis all-reduces, and 3 model-axis ones again at 3 layers), their
  plan signatures and the TuningProfile JSON they save;
* checkpoints across packages both ways, and the launcher's CPU smoke run
  on (2, 4), whose checkpoint the reference restores.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ranks
from repro.core import communicator as j_comm
from repro.core.links import PROFILES as J_PROFILES
from repro.core.links import degrade_profile as j_degrade
from repro_torch.core.links import PROFILES as T_PROFILES
from repro_torch.core.links import degrade_profile as t_degrade
from repro_torch.launch.mesh import run_ranks

STEPS = 3
TOL = 5e-3
#: relative error norms of the state after STEPS steps, as the
#: data-parallel test (tests/test_torch_train.py) bounds them
REL_PARAMS = 5e-4
REL_MOMENTS = 5e-5
#: relative error norm of one gradient leaf (float32)
REL_GRAD = 1e-5
PROFILE = "h800!nvlink=0.1"
SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}
MESH = (2, 4)


def _cfg(n_layers=2):
    from repro.configs import get_config
    return get_config("glm4-9b").reduced(n_layers=n_layers)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    for sub in ("port_ckpt", "ref_ckpt", "json"):
        (d / sub).mkdir()
    pinned = _torch_ranks.pinned_profile(str(d / "pinned.json"), PROFILE, 4,
                                         SHARES)
    comm = {"profile": PROFILE, "tuning_cache": pinned}
    runs = {
        "nccl": {"layers": 2, "steps": STEPS,
                 "comm": dict(comm, backend="nccl")},
        "flexlink": {"layers": 2, "steps": STEPS, "comm": comm,
                     "state": True, "ckpt": True, "record": True},
        "flexlink3": {"layers": 3, "steps": 1, "comm": comm,
                      "record": True},
    }
    return {"dir": d, "comm": comm, "runs": runs}


@pytest.fixture(scope="module")
def init_np():
    import jax
    from repro.models import init_params
    return {n: jax.tree.map(np.asarray,
                            init_params(jax.random.PRNGKey(0), _cfg(n)))
            for n in (2, 3)}


@pytest.fixture(scope="module")
def grad_batch():
    from repro.data.pipeline import make_batches
    return next(make_batches(_cfg(), seq_len=32, batch_per_shard=4, seed=7))


def _device_shards(tree, mesh):
    """{"a/b/c": [float32 numpy of each device's shard, in rank order]}:
    rank r = data * tp + model, the device at that mesh position."""
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                shards = sorted(v.addressable_shards,
                                key=lambda s: order[s.device])
                out[prefix + k] = [np.asarray(s.data, np.float32)
                                   for s in shards]
    walk(tree, "")
    return out


def _ref_run(name, run, init_np, work):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_program
    from repro.optim.adamw import AdamWConfig, init_state
    j_comm.comm_destroy_all()
    cfg = _cfg(run["layers"])
    mesh = make_mesh(MESH, ("data", "model"))
    program, ctx = build_train_program(
        cfg, mesh, comm=j_comm.CommConfig(**run["comm"]),
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        shape=SH.InputShape("t", "train", 32, 4), name=name)
    params = jax.tree.map(jnp.asarray, init_np[run["layers"]])
    opt_state = init_state(params)
    batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
    out = {"losses": []}
    with mesh:
        for i in range(run["steps"]):
            params, opt_state, m = program.step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            out["losses"].append(float(m["loss"]))
            if i == 0 and run.get("record"):
                out["recording"] = _torch_ranks.recording(
                    ctx, name, str(work["dir"] / "json" / f"ref-{name}.json"))
    program.close()
    if run.get("state"):
        out["state"] = {k: _device_shards(t, mesh) for k, t in
                        (("params", params), ("mu", opt_state.mu),
                         ("nu", opt_state.nu))}
    if run.get("ckpt"):
        JCkpt(str(work["dir"] / "ref_ckpt")).save(run["steps"], params,
                                                   opt_state)
        out["saved"] = {k: _torch_ranks.flat_leaves(jax.tree.map(np.asarray,
                                                                 t))
                        for k, t in (("params", params),
                                     ("mu", opt_state.mu),
                                     ("nu", opt_state.nu))}
    j_comm.comm_destroy_all()
    return out


def _ref_grads(init_np, batch, comm):
    """The reference's lm_loss gradient on a (model=4) mesh, inside
    shard_map(check_vma=False): each rank's local gradient leaves."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.models.tp import ParallelCtx
    from repro.models.transformer import lm_loss, param_specs
    j_comm.comm_destroy_all()
    cfg = _cfg()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("model",))
    ctx = ParallelCtx(tp_axis="model", tp_size=4,
                      comm_config=j_comm.CommConfig(**comm))
    psp = param_specs(cfg)

    def shard(p, b):
        loss, g = jax.value_and_grad(
            lambda q: lm_loss(q, b, cfg, ctx, remat=True))(p)
        return loss[None], jax.tree.map(lambda a: a[None], g)

    stacked = jax.tree.map(lambda _: P("model"), psp,
                           is_leaf=lambda x: isinstance(x, P))
    f = jax.jit(shard_map(shard, mesh=mesh, in_specs=(psp, P()),
                          out_specs=(P("model"), stacked), check_vma=False))
    loss, grads = f(jax.tree.map(jnp.asarray, init_np[2]),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    j_comm.comm_destroy_all()
    flat = _torch_ranks.flat_leaves(jax.tree.map(np.asarray, grads))
    return np.asarray(loss), {k: list(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def reference(work, init_np, grad_batch):
    j_degrade(J_PROFILES["h800"], "nvlink=0.1")
    out = {name: _ref_run(name, run, init_np, work)
           for name, run in work["runs"].items()}
    out["grad"] = _ref_grads(init_np, grad_batch, work["comm"])
    return out


@pytest.fixture(scope="module")
def port(work, init_np, grad_batch, reference):
    t_degrade(T_PROFILES["h800"], "nvlink=0.1")
    d = work["dir"]
    return run_ranks(_torch_ranks.tp_train, 8, backend="gloo", device="cpu",
                     timeout_s=600,
                     args=(init_np, work["runs"], STEPS,
                           {"batch": grad_batch, "comm": work["comm"]},
                           str(d / "port_ckpt"), str(d / "ref_ckpt"),
                           str(d / "json")))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_ranks_agree(port):
    """Every rank reports the same losses; every rank of a model line
    records the same calls and plans."""
    for name in ("nccl", "flexlink", "flexlink3"):
        assert all(r[name]["losses"] == port[0][name]["losses"]
                   for r in port), name
    for name in ("flexlink", "flexlink3"):
        assert all(r[name]["recording"] == port[0][name]["recording"]
                   for r in port), name


def test_grads_match_reference_per_rank(port, reference):
    """One gradient of lm_loss at tp = 4 against the reference's under
    check_vma=False: the same tp-scaled sharded gradients and the same
    rank-dependent gradients of the replicated leaves (a relative error
    norm per leaf and rank; an elementwise bound cannot hold for float32
    sums taken in another order)."""
    loss, want = reference["grad"]
    for r in range(8):
        got = port[r]["grad"]
        assert abs(got["loss"] - float(loss[r % 4])) < 1e-5
        assert got["grads"].keys() == want.keys()
        for k, w in want.items():
            e = _rel(got["grads"][k], w[r % 4])
            assert e < REL_GRAD, (r, k, e)
    # the replicated leaves' gradients differ across model ranks
    ln1 = [want["layers/ln1"][m] for m in range(4)]
    assert not np.allclose(ln1[0], ln1[1])


@pytest.mark.parametrize("run", ["nccl", "flexlink"])
def test_losses_match_reference(port, reference, run):
    got, want = port[0][run]["losses"], reference[run]["losses"]
    assert len(got) == STEPS and all(np.isfinite(got))
    assert np.max(np.abs(np.array(got) - np.array(want))) < TOL, (got, want)


def test_flexlink_equals_nccl_backend(port):
    a = np.array(port[0]["flexlink"]["losses"])
    b = np.array(port[0]["nccl"]["losses"])
    assert np.max(np.abs(a - b)) < TOL, (a, b)


def test_state_matches_reference_shards(port, reference, init_np):
    """After 3 steps, every rank's local leaf of the params (as its change
    from the initial shard) and of both moments against the reference
    device's shard at the same mesh position; the replicated leaves'
    copies differ across model ranks in both packages."""
    from repro_torch.convert import shard_params
    from repro_torch.models.transformer import param_specs
    from repro_torch.configs import get_config
    specs = param_specs(get_config("glm4-9b").reduced())
    want = reference["flexlink"]["state"]
    bad = {}
    for r in range(8):
        init = _torch_ranks.flat_leaves(
            shard_params(init_np[2], specs, r % 4, 4))
        got = port[r]["flexlink"]["state"]
        for tree in ("params", "mu", "nu"):
            assert got[tree].keys() == want[tree].keys()
            for k, shards in want[tree].items():
                g, w = got[tree][k], shards[r]
                if tree == "params":
                    g, w = g - init[k], w - init[k]
                e = _rel(g, w)
                if e > (REL_PARAMS if tree == "params" else REL_MOMENTS):
                    bad[r, tree, k] = e
    assert not bad, bad
    for pkg in (want["params"]["layers/ln1"],
                [port[r]["flexlink"]["state"]["params"]["layers/ln1"]
                 for r in range(8)]):
        assert not np.array_equal(pkg[0], pkg[1])        # model 0 vs 1
        np.testing.assert_array_equal(pkg[1], pkg[5])    # data 0 vs 1


@pytest.mark.parametrize("run", ["flexlink", "flexlink3"])
def test_recording_matches_reference(port, reference, run):
    """After one step: 3 model-axis all-reduces (the embedding and layer
    0's attention and MLP combines: lax.scan traces the body once, the
    backward and the recompute record nothing) at 2 and at 3 layers, one
    data-axis all-reduce per gradient leaf; equal plan signatures and
    TuningProfile JSON."""
    got, want = port[0][run]["recording"], reference[run]["recording"]
    assert [c[0] for c in got["model"]["calls"]] == ["all_reduce"] * 3
    assert len(got["data"]["calls"]) == 12
    for axis in ("model", "data"):
        assert got[axis]["calls"] == want[axis]["calls"], axis
        assert got[axis]["signature"] == want[axis]["signature"], axis
    units = dict(dict(got["model"]["signature"][0][2])["chunk_units"])
    assert set(units) == {"primary", "staged", "ortho"}, units
    assert got["profile_json"] == want["profile_json"]


def test_port_checkpoint_restores_in_reference(port, reference, init_np,
                                               work):
    """The port's (2, 4) checkpoint holds the global layout: sharded leaves
    gathered over the model axis, replicated leaves model rank 0's copy;
    the reference restores it."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.configs import get_config
    from repro_torch.convert import gather_params
    from repro_torch.models.transformer import param_specs
    specs = param_specs(get_config("glm4-9b").reduced())
    tmpl = jax.tree.map(np.asarray, init_np[2])
    jp, jopt, meta = JCkpt(str(work["dir"] / "port_ckpt")).restore(
        tmpl, j_init_state(tmpl))
    assert meta["step"] == STEPS and int(jopt.step) == STEPS
    restored = {"params": jp, "mu": jopt.mu, "nu": jopt.nu}
    for tree in ("params", "mu", "nu"):
        local = [_unflat(port[m]["flexlink"]["state"][tree])
                 for m in range(4)]
        want = _torch_ranks.flat_leaves(gather_params(local, specs))
        got = _torch_ranks.flat_leaves(jax.tree.map(np.asarray,
                                                    restored[tree]))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_reference_checkpoint_restores_in_port(port, reference):
    """Every rank restores the reference's (2, 4) checkpoint: its sharded
    leaves equal the reference device's shard at its mesh position, its
    replicated leaves the copy the reference saved (model rank 0's)."""
    want, saved = reference["flexlink"]["state"], \
        reference["flexlink"]["saved"]
    for r in range(8):
        got = port[r]["restored"]
        assert got["step"] == STEPS
        for tree in ("params", "mu", "nu"):
            for k, shards in want[tree].items():
                w = (shards[r] if shards[r].shape != saved[tree][k].shape
                     else saved[tree][k])
                np.testing.assert_array_equal(got[tree][k], w,
                                              err_msg=f"{r} {tree} {k}")


def test_train_launcher_tp_smoke_learns(tmp_path, init_np):
    """``--mesh-shape 2,4`` on 8 gloo CPU ranks: the loss falls, and the
    final checkpoint restores in the reference with its global shapes."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--dist", "gloo", "--mesh-shape", "2,4",
         "--steps", "12", "--ckpt-dir", str(tmp_path)], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("final loss:")][0]
    final, first = (float(v) for v in
                    line.removeprefix("final loss: ").replace(
                        "(from ", "").rstrip(")").split())
    assert np.isfinite(final) and final < first, line
    tmpl = jax.tree.map(np.asarray, init_np[2])
    params, _, meta = JCkpt(str(tmp_path)).restore(tmpl)
    assert meta["step"] == 12
    assert all(np.all(np.isfinite(np.asarray(v)))
               for v in jax.tree.leaves(params))
