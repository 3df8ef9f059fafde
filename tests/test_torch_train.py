"""The port's data-parallel train step against the JAX reference.

Reduced glm4-9b on a (data=2, model=1) mesh, from the reference's
``init_params`` (passed through numpy, ``convert.py``) and the synthetic
corpus of ``make_batches(seed=7)``, three steps of AdamW.  The reference
runs its jitted ``shard_map`` train step on 2 of the conftest's 8 CPU
devices; the port runs ``build_train_program`` + ``run_loop`` on 2 gloo
ranks, spawned ONCE for the module (rank side in ``_torch_ranks.py``).
The per-step loss must agree within the 5e-3 the reference allows itself
(tests/test_integration.py:68-82):

* port against reference, uncompressed;
* port flexlink against port nccl (single-path) — the lossless claim;
* port against reference with ``compress="secondary=fp8"``, at a width
  where the gradient leaves' plans carry ``("staged", "fp8_e4m3")``
  (asserted), so the fp8 codec composites and the codec kernels' plain
  versions run inside the step.

After the steps, the port's params and AdamW moments are held against
the reference's leaf by leaf, uncompressed and under fp8, and the fp8
run must end elsewhere than the uncompressed one.  Both packages use the degraded ``h800!nvlink=0.1`` profile, where fp8
pays from 4 MiB buckets on 2 ranks: at ``reduced(d_model=1024)`` the
attention and MLP gradient leaves (4-16 MiB in float32) take it.  Also
checked: a checkpoint the port writes restores in both packages, and the
train launcher's smoke run on the CPU learns.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks
from repro.core import communicator as j_comm
from repro.core.links import PROFILES as J_PROFILES
from repro.core.links import degrade_profile as j_degrade
from repro_torch.checkpoint.checkpointer import Checkpointer as TCkpt
from repro_torch.core.links import PROFILES as T_PROFILES
from repro_torch.core.links import degrade_profile as t_degrade
from repro_torch.launch.mesh import run_ranks

STEPS = 3
D_MODEL = 1024
TOL = 5e-3
#: relative error norms a leaf of the uncompressed run may have against
#: the reference after STEPS steps (test_train_state_matches_reference)
REL_PARAMS = 5e-4
REL_MOMENTS = 5e-5
PROFILE = "h800!nvlink=0.1"
RUNS = {
    "flexlink": {"d_model": D_MODEL, "comm": {"profile": PROFILE},
                 "state": True},
    "nccl": {"d_model": D_MODEL, "comm": {"profile": PROFILE,
                                          "backend": "nccl"}},
    "fp8": {"d_model": D_MODEL, "comm": {"profile": PROFILE,
                                         "compress": "secondary=fp8"},
            "ckpt": True, "state": True},
}


def _cfg():
    from repro.configs import get_config
    return get_config("glm4-9b").reduced(d_model=D_MODEL)


@pytest.fixture(scope="module")
def init_np():
    import jax
    from repro.models import init_params
    params = init_params(jax.random.PRNGKey(0), _cfg())
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def port(init_np, ckpt_dir):
    t_degrade(T_PROFILES["h800"], "nvlink=0.1")
    return run_ranks(_torch_ranks.train, 2, backend="gloo", device="cpu",
                     timeout_s=600, args=(init_np, RUNS, STEPS, ckpt_dir))


@pytest.fixture(scope="module")
def reference(init_np):
    """The reference's run of each case, made once: (losses, final state)."""
    done = {}

    def get(run):
        if run not in done:
            done[run] = _reference_run(init_np, RUNS[run]["comm"])
        return done[run]
    return get


def _reference_run(init_np, comm):
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_step
    from repro.optim.adamw import AdamWConfig, init_state
    j_degrade(J_PROFILES["h800"], "nvlink=0.1")
    j_comm.comm_destroy_all()
    cfg = _cfg()
    mesh = make_mesh((2, 1), ("data", "model"))
    step, _ = build_train_step(
        cfg, mesh, comm=j_comm.CommConfig(**comm),
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        shape=SH.InputShape("t", "train", 32, 4))
    params = jax.tree.map(jnp.asarray, init_np)
    opt_state = init_state(params)
    batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
    losses = []
    with mesh:
        for _ in range(STEPS):
            params, opt_state, m = step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            losses.append(float(m["loss"]))
    j_comm.comm_destroy_all()
    state = {k: _torch_ranks.flat_leaves(jax.tree.map(np.asarray, t))
             for k, t in (("params", params), ("mu", opt_state.mu),
                          ("nu", opt_state.nu))}
    return losses, state


def test_ranks_agree(port):
    for name in RUNS:
        assert port[0][name]["losses"] == port[1][name]["losses"], name
        assert port[0][name]["signature"] == port[1][name]["signature"]


@pytest.mark.parametrize("run", ["flexlink", "fp8"])
def test_train_losses_match_reference(port, reference, run):
    want = reference(run)[0]
    got = port[0][run]["losses"]
    assert len(got) == STEPS and all(np.isfinite(got))
    assert np.max(np.abs(np.array(got) - np.array(want))) < TOL, (got, want)


def _rel_errs(got, want, init):
    """Per tree and leaf, ||got - want|| / ||want||; params as their
    change over the run (final - initial), moments as they are."""
    out = {}
    for tree in ("params", "mu", "nu"):
        assert got[tree].keys() == want[tree].keys()
        for k, w in want[tree].items():
            g = got[tree][k]
            if tree == "params":
                g, w = g - init[k], w - init[k]
            out[tree, k] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    return out


@pytest.mark.parametrize("run", ["flexlink", "fp8"])
def test_train_state_matches_reference(port, reference, init_np, run):
    """After the 3 steps, every leaf of the params and of both AdamW
    moments against the reference's, as a relative error norm.  An
    elementwise bound cannot hold: AdamW divides each gradient by its own
    root mean square, so a float32 summation-order difference in a
    gradient near zero moves that element's update by up to lr.

    Uncompressed, the moments agree within REL_MOMENTS (measured: below
    1e-5) and the params' change within REL_PARAMS (measured: 1.5e-4 at
    most); the decoupled weight decay alone moves the change by 1.9e-3 or
    more a leaf, so a missing or wrong decay term fails.  Under fp8 an
    input that differs by float32 noise may round to the neighbouring fp8
    value, and the runs drift further apart (measured: 3.4e-3 at most), so
    each leaf's error must instead stay under a quarter of what the
    compression itself does to that leaf in the reference (fp8 against
    uncompressed, 3e-3 to 4e-2): a port whose fp8 sync quantized nothing,
    or lost a received partial, fails."""
    init = _torch_ranks.flat_leaves(init_np)
    errs = _rel_errs(port[0][run]["state"], reference(run)[1], init)
    if run == "flexlink":
        bad = {k: e for k, e in errs.items()
               if e > (REL_PARAMS if k[0] == "params" else REL_MOMENTS)}
    else:
        effect = _rel_errs(reference("fp8")[1], reference("flexlink")[1],
                           init)
        bad = {k: (e, effect[k]) for k, e in errs.items()
               if e > 0.25 * effect[k]}
    assert not bad, bad


def test_fp8_state_differs_from_uncompressed(port, init_np):
    """The port's fp8 run ends elsewhere than its uncompressed run, most
    on the leaves whose plans carry the codec (4 MiB and more)."""
    init = _torch_ranks.flat_leaves(init_np)
    errs = _rel_errs(port[0]["fp8"]["state"], port[0]["flexlink"]["state"],
                     init)
    assert all(e > 0 for e in errs.values()), errs
    codec_leaves = {k: e for k, e in errs.items()
                    if init[k[1]].size >= 1 << 20}
    assert len(codec_leaves) == 3 * 7
    assert min(codec_leaves.values()) > 5e-3, codec_leaves


def test_fp8_plans_carry_the_codec(port):
    """The compressed run's gradient reduces went through fp8 staged
    plans; the uncompressed ones through none."""
    assert port[0]["fp8"]["codecs"] == [("staged", "fp8_e4m3")]
    assert port[0]["flexlink"]["codecs"] == []


def test_error_feedback_gate_matches_reference(port):
    """``ef_codec_name`` and the per-bucket ``ef_active_for`` answer as the
    reference's ParallelCtx does for the same comm config."""
    import jax.numpy as jnp
    from repro.models.tp import ParallelCtx as JCtx
    j_degrade(J_PROFILES["h800"], "nvlink=0.1")
    for name, run in RUNS.items():
        j_comm.comm_destroy_all()
        ctx = JCtx(dp_axis="data", dp_size=2,
                   comm_config=j_comm.CommConfig(**run["comm"]))
        want = (ctx.ef_codec_name(),
                [ctx.ef_active_for(nb, dt) for nb in _torch_ranks.EF_SIZES
                 for dt in (jnp.float32, jnp.bfloat16)])
        assert tuple(port[0][name]["ef"]) == (want[0], want[1]), name
    j_comm.comm_destroy_all()


def test_flexlink_equals_nccl_backend(port):
    """The multi-path backend is numerically the single-path one."""
    a = np.array(port[0]["flexlink"]["losses"])
    b = np.array(port[0]["nccl"]["losses"])
    assert np.max(np.abs(a - b)) < TOL, (a, b)


def test_checkpoint_restores_in_both_packages(port, init_np, ckpt_dir):
    """The port's final checkpoint (fp8 run) restores through the port's
    Checkpointer and the reference's, with the reference's keys."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.convert import params_from_reference
    from repro_torch.optim.adamw import init_state as t_init_state
    final = port[0]["final"]
    t_params = params_from_reference(init_np)
    tp, topt, meta = TCkpt(ckpt_dir).restore(t_params,
                                             t_init_state(t_params))
    assert meta["step"] == STEPS
    np.testing.assert_array_equal(_torch_ranks.as_bits(tp["embed"]),
                                  final["embed"])
    np.testing.assert_array_equal(
        _torch_ranks.as_bits(topt.mu["layers"]["attn"]["wq"]),
        final["mu_wq"])
    assert int(topt.step) == STEPS == int(final["step"])
    j_params = jax.tree.map(np.asarray, init_np)
    jp, jopt, _ = JCkpt(ckpt_dir).restore(j_params, j_init_state(j_params))
    np.testing.assert_array_equal(np.asarray(jp["embed"]), final["embed"])
    np.testing.assert_array_equal(
        np.asarray(jopt.mu["layers"]["attn"]["wq"]), final["mu_wq"])


def test_one_device_step_matches_reference(init_np):
    """``build_train_step`` without a mesh (one device, the launcher's
    ``world == 1`` path) against the reference's on a (1, 1) mesh."""
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import make_batches as j_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_step as j_build
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_state
    j_comm.comm_destroy_all()
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep, _ = j_build(_cfg(), mesh, opt=JOpt(lr=1e-3, warmup_steps=2,
                                              total_steps=20),
                       shape=SH.InputShape("t", "train", 32, 4))
    jp = jax.tree.map(jnp.asarray, init_np)
    js = j_init_state(jp)
    tcfg = get_config("glm4-9b").reduced(d_model=D_MODEL)
    step, ctx = build_train_step(tcfg, opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20), device="cpu")
    assert ctx.comms() == ()
    tp = params_from_reference(init_np)
    ts = init_state(tp)
    jb = j_batches(_cfg(), seq_len=32, batch_per_shard=4, seed=7)
    tb = make_batches(tcfg, seq_len=32, batch_per_shard=4, seed=7)
    with mesh:
        for _ in range(2):
            jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                        for k, v in next(jb).items()})
            tp, ts, tm = step(tp, ts, next(tb))
            assert abs(float(tm["loss"]) - float(jm["loss"])) < TOL
    j_comm.comm_destroy_all()


def test_train_launcher_smoke_learns():
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--dist", "gloo", "--mesh-shape", "2,1",
         "--steps", "12"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("final loss:")][0]
    final, first = (float(v) for v in
                    line.removeprefix("final loss: ").replace(
                        "(from ", "").rstrip(")").split())
    assert np.isfinite(final) and final < first, line


def test_train_launcher_bucketed_smoke_learns():
    """``--bucket-mb`` trains: buckets launched from the backward on 2
    gloo ranks, with fp8 error-feedback residuals paired with the AdamW
    state."""
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--dist", "gloo", "--mesh-shape", "2,1",
         "--steps", "12", "--bucket-mb", "4", "--compress",
         "secondary=fp8"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("final loss:")][0]
    final, first = (float(v) for v in
                    line.removeprefix("final loss: ").replace(
                        "(from ", "").rstrip(")").split())
    assert np.isfinite(final) and final < first, line


def test_train_launcher_refuses_what_is_not_ported(capsys):
    """--pods without --nodes (the reference's message: the pod tier
    composes above the NIC tier), a node event of --fault with --pods
    (elastic resume rebuilds no pod axis), a node event without
    --ckpt-dir (the reference's refusal: resume needs a snapshot) and a
    batch that does not divide over node x data exit 2, before any rank
    is spawned; --nodes, --pods and --fault themselves are ported
    (tests/test_torch_cluster.py, test_torch_pod.py,
    test_torch_faults.py)."""
    from repro_torch.launch import train
    assert train.main(["--smoke", "--device", "cpu", "--dist", "gloo",
                       "--fault", "node1@step2=down", "--nodes", "2",
                       "--mesh-shape", "2,1"]) == 2
    assert ("elastic node loss needs --ckpt-dir: resume is only defined "
            "from a Checkpointer snapshot") in capsys.readouterr().err
    assert train.main(["--smoke", "--device", "cpu", "--dist", "gloo",
                       "--fault", "node1@step2=down", "--nodes", "2",
                       "--pods", "2", "--ckpt-dir", "unused",
                       "--mesh-shape", "1,1"]) == 2
    assert "--fault node events with --pods > 1" in \
        capsys.readouterr().err
    assert train.main(["--smoke", "--device", "cpu", "--dist", "gloo",
                       "--nodes", "3", "--mesh-shape", "2,1"]) == 2
    assert train.main(["--smoke", "--device", "cpu", "--dist", "gloo",
                       "--pods", "2", "--mesh-shape", "2,1"]) == 2
    assert ("--pods > 1 needs a multi-node cluster run (--nodes/--cluster): "
            "the pod tier composes above the NIC tier") in \
        capsys.readouterr().err
    assert train.main(["--smoke", "--device", "cpu", "--mesh-shape",
                       "2,1"]) == 2                   # nccl on the CPU
    if not torch.cuda.is_available():
        assert train.main(["--smoke", "--steps", "1"]) == 2
