"""The four port examples (``examples/*_torch.py``) against the reference's
examples, on the CPU:

* the tuning demo: both run as subprocesses, their stdout byte for byte
  equal;
* the quickstart: its Stage-1 line equals the reference example's (run as
  a subprocess on 8 CPU devices), and its multi-path all-gather is bit
  for bit the single-path one on every one of 8 gloo ranks;
* serve_decode, given the reference's ``init_params(PRNGKey(0), cfg)``
  through ``convert.params_from_reference``: its stdout byte for byte the
  reference example's, so the seven greedy streams are equal;
* train_lm at ``--steps 3`` on (data=2, model=4) gloo ranks, from the same
  converted params: losses equal on every rank, falling, and within 5e-3
  (the ``TOL`` of tests/test_torch_tp_train.py) of the reference's
  ``build_train_step`` step on the same config, batches and ``h100``
  profile, built without donation: the donated step fails in XLA under
  jax 0.9.0 with the aliasing error of ROADMAP queue 3, which the
  reference's own ``examples/train_lm.py`` hits too.  The reference step
  runs in this thread while the port's ranks spawn in another;
* without a card, and with ``--dist nccl`` on the CPU, every example that
  takes a device exits 2.

The examples' rank bodies are imported by spawned ranks as
``examples.<name>`` (a namespace package), so the repo root goes on
``sys.path``, which the spawned ranks inherit.
"""

import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro_torch.convert import params_from_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from examples import quickstart_torch, serve_decode_torch  # noqa: E402
from examples import train_lm_torch  # noqa: E402

TOL = 5e-3
TRAIN_STEPS = 3
#: the reference examples whose whole stdout a test reads
REF_EXAMPLES = ("flexlink_tuning_demo", "quickstart", "serve_decode")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def _start(script, *argv):
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script),
                             *argv], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def ref_out():
    """The reference examples' stdout, all three started at once."""
    procs = {name: _start(f"{name}.py") for name in REF_EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (name, stderr[-2000:])
            out[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def test_tuning_demo_stdout_equals_reference(ref_out):
    proc = _start("flexlink_tuning_demo_torch.py")
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-2000:]
    assert stdout == ref_out["flexlink_tuning_demo"]
    assert "== Stage 2" in stdout and "timing source: sim" in stdout


def test_quickstart_matches_reference(ref_out, capsys):
    ranks = quickstart_torch.main(["--device", "cpu", "--dist", "gloo"])
    lines = capsys.readouterr().out.splitlines()
    want = ref_out["quickstart"].splitlines()
    assert lines[0] == want[0] and lines[0].startswith("8-GPU AllGather")
    assert "not measured" in lines[1]
    assert lines[-1] == want[-1]
    assert len(ranks) == 8
    x = np.arange(4 * 6 * 5, dtype=np.float32).reshape(24, 5)
    for got in ranks:
        assert got["flex"].tobytes() == got["single"].tobytes() == \
            x.tobytes()


def _j_init(cfg):
    from repro.models.transformer import init_params
    return jax.tree.map(np.asarray, jax.jit(
        init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))


def test_serve_decode_streams_equal_reference(ref_out, capsys):
    from repro.configs import get_config
    params = params_from_reference(
        _j_init(get_config("zamba2-1.2b").reduced()))
    fin = serve_decode_torch.main(["--device", "cpu"], params=params)
    assert capsys.readouterr().out == ref_out["serve_decode"]
    assert len(fin) == 7 and all(len(v) == 10 for v in fin.values())


def _ref_train(cfg, params_np, steps):
    """The reference example's training run, its step built as
    ``launch/steps.py`` builds it but jitted without donation."""
    from repro.compat import shard_map
    from repro.core import communicator as j_comm
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch import steps as JS
    from repro.launch.mesh import make_mesh
    from repro.models.transformer import param_specs
    from repro.optim.adamw import AdamWConfig, init_state
    from repro.train.train_step import make_train_step
    j_comm.comm_destroy_all()
    mesh = make_mesh((2, 4), ("data", "model"))
    ctx = JS.make_ctx(mesh, j_comm.CommConfig(backend="flexlink",
                                              profile="h100"))
    psp = param_specs(cfg, data_axis=ctx.ep_spec_axis() or "data")
    osp = JS.opt_state_specs(psp)
    step = jax.jit(shard_map(
        make_train_step(cfg, ctx, AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=steps),
                        remat=True),
        mesh=mesh, in_specs=(psp, osp, JS._batch_specs(
            cfg, SH.InputShape("ex", "train", 128, 8), mesh)),
        out_specs=(psp, osp, P()), check_vma=False))
    params = jax.tree.map(jnp.asarray, params_np)
    opt_state = init_state(params)
    batches = make_batches(cfg, seq_len=128, batch_per_shard=8)
    losses = []
    with mesh:
        for _ in range(steps):
            params, opt_state, m = step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            losses.append(float(m["loss"]))
    j_comm.comm_destroy_all()
    return losses


def test_train_lm_losses_match_reference(capsys):
    from repro.models.config import ArchConfig
    jcfg = ArchConfig("lm-mini", "dense", n_layers=4, d_model=256,
                      n_heads=8, n_kv_heads=4, d_ff=1024, vocab=2048,
                      param_dtype="float32")
    params_np = _j_init(jcfg)
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(train_lm_torch.main,
                         ["--device", "cpu", "--dist", "gloo", "--steps",
                          str(TRAIN_STEPS)],
                         params=params_from_reference(params_np))
        want = _ref_train(jcfg, params_np, TRAIN_STEPS)
        ranks = port.result(timeout=600)
    out = capsys.readouterr().out.splitlines()
    got = ranks[0]
    assert len(ranks) == 8 and all(r == got for r in ranks)
    assert len(got) == TRAIN_STEPS and all(np.isfinite(got))
    assert got[-1] < got[0] and want[-1] < want[0]
    assert np.max(np.abs(np.array(got) - np.array(want))) < TOL, (got, want)
    assert out[-1] == (f"loss {got[0]:.3f} -> {got[-1]:.3f} over "
                       f"{TRAIN_STEPS} steps on a (2x4) mesh with the "
                       f"FlexLink backend")


@pytest.mark.parametrize("example,argv", [
    (quickstart_torch, ["--device", "cpu", "--dist", "nccl"]),
    (train_lm_torch, ["--device", "cpu", "--dist", "nccl"]),
    (quickstart_torch, []),
    (train_lm_torch, ["--dist", "gloo"]),
    (serve_decode_torch, []),
], ids=["quickstart-cpu-nccl", "train_lm-cpu-nccl", "quickstart-default",
        "train_lm-cuda-gloo", "serve_decode-default"])
def test_examples_refuse_what_they_cannot_run(example, argv, capsys):
    """``--dist nccl`` needs cards; the default ``--device cuda`` needs a
    card: each exits 2 with its reason, and never falls back."""
    if "--device" not in argv and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda runs here")
    with pytest.raises(SystemExit) as e:
        example.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and ("nccl" in err or "no CUDA card"
                                          in err)
