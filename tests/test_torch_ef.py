"""Error feedback on the port's bucketed gradient sync against the JAX
reference (DESIGN.md §12, tests/test_codecs.py:482-580).

Reduced glm4-9b from the reference's initial params on the (data=2,
model=4) mesh: 8 gloo ranks spawned ONCE for the module (rank side in
``_torch_ranks.ef_train``), each run bucketed, with the residuals paired
with the AdamW state whenever the comm config's codec is lossy:

* degraded h800 (nvlink at 5% of nominal) with ``secondary=fp8`` at
  ``bucket_mb`` 8: the tuner routes share onto the secondaries and
  attaches fp8, so the residuals are live in both packages, the port's
  per-step loss stays within 5e-3 of the reference's and its final
  residuals, leaf by leaf, near the reference's;
* healthy h800 at ``bucket_mb`` 0.25: every gradient slot declines fp8,
  so each bucket skips the roundtrip, the residuals stay 0 and the losses
  equal the uncompressed run's (rtol 1e-6);
* ``secondary=bf16`` on float32 gradients is lossy (bf16_pack truncates
  mantissas): the residuals are paired and live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from repro.core import communicator as j_comm
from repro.core.links import PROFILES as J_PROFILES
from repro.core.links import degrade_profile as j_degrade
from repro_torch.core.links import PROFILES as T_PROFILES
from repro_torch.core.links import degrade_profile as t_degrade
from repro_torch.launch.mesh import run_ranks

TOL = 5e-3
FP8_STEPS = 6
#: relative error norm a residual leaf of the port's fp8 run may have
#: against the reference's (test_fp8_ef_losses_match_reference)
RES_REL = 0.5
RUNS = {
    "fp8": {"profile": "h800!nvlink=0.05", "compress": "secondary=fp8",
            "bucket_mb": 8.0, "steps": FP8_STEPS, "state": True},
    "base": {"profile": "h800!nvlink=0.05", "compress": "",
             "bucket_mb": 8.0, "steps": FP8_STEPS},
    "declined": {"profile": "h800", "compress": "secondary=fp8",
                 "bucket_mb": 0.25, "steps": 4},
    "off": {"profile": "h800", "compress": "", "bucket_mb": 0.25,
            "steps": 4},
    "bf16": {"profile": "h800!nvlink=0.02", "compress": "secondary=bf16",
             "bucket_mb": 8.0, "steps": 4},
}


@pytest.fixture(scope="module")
def init_np():
    from repro.configs import get_config
    from repro.models import init_params
    return jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), get_config("glm4-9b").reduced()))


@pytest.fixture(scope="module")
def port(init_np):
    for f in (0.05, 0.02):
        t_degrade(T_PROFILES["h800"], f"nvlink={f}")
    res = run_ranks(_torch_ranks.ef_train, 8, backend="gloo", device="cpu",
                    timeout_s=600, args=(init_np, RUNS))
    for name in RUNS:
        assert all(r[name]["losses"] == res[0][name]["losses"]
                   for r in res), name
    rmax = {name: (None if res[0][name]["rmax"] is None
                   else max(r[name]["rmax"] for r in res))
            for name in RUNS}
    out = {name: {**res[0][name], "rmax": rmax[name]} for name in RUNS}
    # the residual tree a reference checkpoint would hold: data row 0's
    # model ranks' shards, put together (model rank 0's replicated leaves)
    from repro_torch.configs import get_config
    from repro_torch.convert import gather_params
    from repro_torch.models.transformer import param_specs
    out["fp8"]["residuals"] = gather_params(
        [r["fp8"]["residuals"] for r in res[:4]],
        param_specs(get_config("glm4-9b").reduced()))
    return out


def _reference_run(init_np, run):
    """The reference's bucketed run (tests/test_codecs.py's _run_train):
    (per-step losses, max |residual| or None without EF)."""
    from repro.configs import get_config
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_step
    from repro.optim.adamw import AdamWConfig, init_state
    from repro.train.train_step import ef_init_residuals
    base, _, spec = run["profile"].partition("!")
    if spec:
        j_degrade(J_PROFILES[base], spec)
    j_comm.comm_destroy_all()
    cfg = get_config("glm4-9b").reduced()
    mesh = make_mesh((2, 4), ("data", "model"))
    step, ctx = build_train_step(
        cfg, mesh, comm=j_comm.CommConfig(profile=run["profile"],
                                          compress=run["compress"]),
        shape=SH.InputShape("t", "train", 32, 4),
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=run["steps"]),
        bucket_mb=run["bucket_mb"])
    params = jax.tree.map(jnp.asarray, init_np)
    opt_state = init_state(params)
    ef = bool(ctx.ef_codec_name())
    if ef:
        opt_state = (opt_state, ef_init_residuals(params))
    batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
    losses = []
    with mesh:
        for _ in range(run["steps"]):
            params, opt_state, m = step(params, opt_state,
                                        {k: jnp.asarray(v)
                                         for k, v in next(batches).items()})
            losses.append(float(m["loss"]))
    j_comm.comm_destroy_all()
    rmax = (max(float(jnp.abs(r).max())
                for r in jax.tree_util.tree_leaves(opt_state[1]))
            if ef else None)
    residuals = (_torch_ranks.flat_leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), opt_state[1])) if ef else None)
    return losses, rmax, residuals


def test_fp8_ef_losses_match_reference(port, init_np):
    want, j_rmax, j_res = _reference_run(init_np, RUNS["fp8"])
    got = port["fp8"]
    assert got["codec"] == "fp8_e4m3"
    assert j_rmax is not None and j_rmax > 0.0
    assert got["rmax"] is not None and got["rmax"] > 0.0
    # the residuals carry the same quantization error (measured: 1.5e-4
    # apart, relative)
    assert abs(got["rmax"] - j_rmax) <= 0.05 * j_rmax, (got["rmax"], j_rmax)
    assert len(got["losses"]) == FP8_STEPS
    assert np.all(np.isfinite(got["losses"]))
    assert np.max(np.abs(np.array(got["losses"]) - np.array(want))) < TOL, \
        (got["losses"], want)
    # the residuals leaf by leaf, as a relative error norm: float32
    # noise moves some inputs across an fp8 rounding boundary, so the
    # runs' residuals drift apart (measured: 0.0035 to 0.17 a leaf after 6
    # steps); a residual not carried, not refreshed or of the wrong sign
    # is 1 or more away
    mine = _torch_ranks.flat_leaves(got["residuals"])
    assert mine.keys() == j_res.keys()
    errs = {k: float(np.linalg.norm(mine[k] - w) / np.linalg.norm(w))
            for k, w in j_res.items()}
    assert max(errs.values()) < RES_REL, errs


def test_fp8_ef_learns_within_tolerance_of_uncompressed(port):
    """tests/test_codecs.py's accuracy contract, on the port's runs: both
    learn, and the lossy run ends within 0.05 max(|loss|, 1) of the
    uncompressed one."""
    base, fp8 = port["base"]["losses"], port["fp8"]["losses"]
    assert port["base"]["rmax"] is None
    assert base[-1] < base[0] and fp8[-1] < fp8[0]
    assert abs(fp8[-1] - base[-1]) < 0.05 * max(abs(base[-1]), 1.0)


def test_ef_skipped_when_every_slot_declines_the_codec(port):
    got = port["declined"]
    assert got["codec"] == "fp8_e4m3"
    assert got["rmax"] == 0.0, f"EF perturbed an exact transfer: {got}"
    np.testing.assert_allclose(got["losses"], port["off"]["losses"],
                               rtol=1e-6)


def test_bf16_on_fp32_gradients_counts_as_lossy_for_ef(port):
    from repro_torch.core.communicator import CommConfig
    from repro_torch.models.tp import ParallelCtx
    ctx = ParallelCtx(comm_config=CommConfig(profile="h800",
                                             compress="secondary=bf16"))
    assert ctx.ef_codec_name() == "bf16_pack"
    assert ctx.ef_codec_name("bfloat16") == ""
    got = port["bf16"]
    assert got["codec"] == "bf16_pack"
    assert got["rmax"] is not None and got["rmax"] > 0.0
    assert np.all(np.isfinite(got["losses"]))
