"""The port's overlapped bucketed gradient sync against the JAX reference
(DESIGN.md §11, tests/test_overlap.py).

Four gloo ranks are spawned ONCE for the module (rank side in
``_torch_ranks.overlap``):

* on a flat (4,) data mesh, bucketed and monolithic ``sync_grads`` of
  small-integer gradients — every partial sum exact in float32 and
  bfloat16, so any summation order gives the same bits — are equal bit
  for bit, and equal to the reference's bucketed output, at the fixed
  grid of tests/test_overlap.py's flat cases (float32 / bfloat16 x ep
  off / on; its ``cluster`` cases run on (node=2, data=4) in
  tests/test_torch_cluster.py);
* the StepProgram issue/await lifecycle through ``ctx.issue``;
* on (data=2, model=2), reduced glm4-9b: the train step whose buckets go
  out from the backward's tensor hooks issues the tags, plans and
  sub-recorder contents of a post-backward ``sync_grads`` loop, in the
  same order, each leaf hook fires once a step, and the losses are the
  same; an issue scope inside ``unrecorded`` raises;
* a bucketed fp8 run with error-feedback residuals on (2, 2), checkpointed
  by the port: it restores in the port (every rank its shards) and in the
  reference.

In this process: the issue windows' disjoint per-bucket Stage-2
multisets (tests/test_overlap.py:184-228, on the port's communicator)
and the tensor-hook contract the hooked step relies on.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import _torch_ranks
from repro.compat import shard_map
from repro.core import communicator as j_comm
from repro_torch.core.communicator import (CommConfig, comm_destroy_all,
                                           comm_init_rank)
from repro_torch.core.links import PROFILES as T_PROFILES
from repro_torch.core.links import degrade_profile as t_degrade
from repro_torch.core.topology import Collective
from repro_torch.launch.mesh import run_ranks

AR = Collective.ALL_REDUCE
STEPS = 2
BUCKET_MB = 0.25            # reduced glm4-9b on (2, 2): several buckets
EF = {"profile": "h800!nvlink=0.05", "compress": "secondary=fp8",
      "bucket_mb": 8.0}
#: tests/test_overlap.py:163-181's flat corners, plus the other two
GRID = [("float32", False), ("bfloat16", True), ("float32", True),
        ("bfloat16", False)]


def _mb(nbytes: int) -> float:
    return nbytes / 2.0 ** 20


def _int_grads(rng, world: int, ep: bool):
    """tests/test_overlap.py's small-integer gradients (global, float32)."""
    g = {"deep": {"w": rng.integers(0, 8, size=(world * 24, 8))},
         "mid": rng.integers(0, 8, size=(world * 4, 3)),
         "tail": rng.integers(0, 8, size=(world, 2))}
    if ep:
        g["moe"] = {"experts": {"wi": rng.integers(0, 8,
                                                   size=(world * 8, 5))}}
    return jax.tree.map(lambda a: a.astype(np.float32), g)


def _case(dtype, ep):
    return f"{dtype}-ep{int(ep)}"


@pytest.fixture(scope="module")
def parity():
    return {_case(dt, ep): {"grads": _int_grads(np.random.default_rng(7), 4,
                                                ep),
                            "dtype": dt, "ep": ep, "bucket_mb": _mb(256)}
            for dt, ep in GRID}


@pytest.fixture(scope="module")
def init_np():
    from repro.configs import get_config
    from repro.models import init_params
    return jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), get_config("glm4-9b").reduced()))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def port(parity, init_np, ckpt_dir):
    t_degrade(T_PROFILES["h800"], "nvlink=0.05")
    return run_ranks(_torch_ranks.overlap, 4, backend="gloo", device="cpu",
                     timeout_s=600,
                     args=(parity, init_np, STEPS, BUCKET_MB, EF, ckpt_dir))


def _reference_bucketed(case):
    """The reference's bucketed sync of one parity case: the global
    output, rank r's block at rows r."""
    from repro.models.tp import ParallelCtx as JCtx
    from repro.train.train_step import sync_grads as j_sync
    j_comm.comm_destroy_all()
    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(4), ("data",))
    ctx = JCtx(dp_axis="data", dp_size=4,
               comm_config=j_comm.CommConfig(profile="tpu_v5e",
                                             tag="ov-flat"))
    cfg = SimpleNamespace(moe=SimpleNamespace(impl="ep_a2a")
                          if case["ep"] else None)
    grads = jax.tree.map(lambda a: jnp.asarray(a).astype(case["dtype"]),
                         case["grads"])
    f = shard_map(lambda t: ctx.await_all(j_sync(
        t, cfg, ctx, bucket_mb=case["bucket_mb"])), mesh=mesh,
        in_specs=(P("data"),), out_specs=P("data"), check_vma=False)
    out = jax.jit(f)(grads)
    j_comm.comm_destroy_all()
    return _torch_ranks.flat_leaves(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), out))


@pytest.mark.parametrize("dtype,ep", GRID)
def test_bucketed_sync_bit_exact_vs_monolithic_and_reference(
        port, parity, dtype, ep):
    name = _case(dtype, ep)
    want = _reference_bucketed(parity[name])
    for r, got in enumerate(port):
        mono, buck = got[name]["mono"], got[name]["buck"]
        assert mono.keys() == buck.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(buck[k], mono[k], err_msg=k)
            rows = want[k].shape[0] // 4
            np.testing.assert_array_equal(
                buck[k], want[k][r * rows:(r + 1) * rows], err_msg=k)


def test_step_program_issue_await_lifecycle(port):
    x = (np.arange(4 * 8, dtype=np.float32) % 5).reshape(4, 8, 1)
    want = 3.0 * x.sum(0)
    for got in port:
        lc = got["lifecycle"]
        assert lc["pending"] == (False, True)
        assert lc["ready"] and lc["n_out"] == 1 and lc["left"] == 0
        np.testing.assert_array_equal(lc["y"], want)
        # per-bucket sub-recorders sharing one window of population 2
        assert lc["calls"] == (1, 1) and lc["same_window"]
        assert lc["population"] == 2.0
        # second round: a cache hit, the same result
        np.testing.assert_array_equal(lc["y2"], lc["y"])
        assert lc["hits"] >= 1
        assert lc["empty_await"] == []


def test_hooked_step_issues_like_the_post_backward_loop(port):
    """Same tags in the same order (each from inside the backward), the
    same per-bucket sub-recorder contents and window populations on both
    communicators, the same plans and the same losses."""
    for got in port:
        h, p = got["hooked"], got["post"]
        n = h["n_buckets"]
        assert n > 3
        tags = [f"g{k}" for k in range(n)]
        assert [t for t, _ in h["issued"]] == tags * STEPS
        assert all(inside for _, inside in h["issued"])
        assert p["issued"] == tags * STEPS
        assert h["recorders"] == p["recorders"]
        rec = h["recorders"]["data"]
        assert rec["base"] == 0 and rec["windows"] == 1
        assert all(len(calls) == 1 and calls[0][2] == float(n)
                   for calls in rec["buckets"])
        assert h["signature"] == p["signature"]
        assert h["losses"] == p["losses"]
    assert port[0]["hooked"]["losses"] == port[3]["hooked"]["losses"]


def test_each_leaf_hook_fires_once_a_step(port):
    for got in port:
        h = got["hooked"]
        per_step = np.array(h["ready"]).reshape(STEPS, -1)
        for step in per_step:
            assert sorted(step) == list(range(h["n_leaves"]))


def test_issue_inside_unrecorded_raises(port):
    assert all(got["hooked"]["refused"] for got in port)


def test_error_feedback_checkpoint_restores_in_both_packages(
        port, init_np, ckpt_dir):
    """The (2, 2) fp8 run's residuals are live, its checkpoint holds them
    under the reference's keys, every rank restores its shards, and the
    reference restores the global tree the ranks were cut from.  The file
    holds one copy of what the ranks may hold differently, as the
    reference's ``np.asarray`` of such a leaf does: model rank 0's
    replicated leaves, and data row 0's residuals (each rank's own
    quantization error)."""
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params, spec_dim
    from repro_torch.models.transformer import param_specs
    specs = _torch_ranks.flat_leaves(jax.tree.map(
        lambda s: np.float32(spec_dim(s, "model") >= 0),
        param_specs(get_config("glm4-9b").reduced()),
        is_leaf=lambda s: isinstance(s, tuple)))

    def held(r, tree, key):
        """Whether rank r's own copy of a leaf is the one the file holds."""
        data, model = divmod(r, 2)
        return ((specs[key] or model == 0)
                and (tree != "residuals" or data == 0))

    assert max(got["ef"]["rmax"] for got in port) > 0
    for r, got in enumerate(port):
        ef = got["ef"]
        assert ef["codec"] == "fp8_e4m3"
        assert ef["restored"]["step"] == STEPS
        for tree in ("params", "mu", "residuals"):
            want = ef[tree]
            assert ef["restored"][tree].keys() == want.keys()
            for k in want:
                if held(r, tree, k):
                    np.testing.assert_array_equal(ef["restored"][tree][k],
                                                  want[k], err_msg=k)
    with np.load(f"{ckpt_dir}/ckpt_{STEPS:08d}.npz") as z:
        keys = set(z.files)
    assert "opt/0/step" in keys and "opt/1/lm_head" in keys
    assert "opt/0/mu/layers/attn/wq" in keys
    template = (j_init_state(init_np), jax.tree.map(np.zeros_like, init_np))
    _, (jstate, jres), meta = JCkpt(ckpt_dir).restore(init_np, template)
    assert meta["step"] == STEPS and int(jstate.step) == STEPS
    for r, got in enumerate(port):
        for tree, want in (("residuals", jres), ("mu", jstate.mu)):
            mine = _torch_ranks.flat_leaves(shard_params(
                jax.tree.map(lambda a: np.asarray(a, np.float32), want),
                param_specs(get_config("glm4-9b").reduced()), r % 2, 2))
            for k, v in got["ef"][tree].items():
                if held(r, tree, k):
                    np.testing.assert_array_equal(v, mine[k], err_msg=k)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_comms():
    comm_destroy_all()
    yield
    comm_destroy_all()


def test_inflight_buckets_keep_disjoint_stage2_multisets(fresh_comms):
    comm = comm_init_rank("x", 8, CommConfig(profile="h800"))
    comm.register_recorder("train")
    with comm.recording(comm.recorder("train"), name="train"):
        with comm.issue_scope("g0"):
            comm.plan_for(AR, torch.zeros((512, 512)))
        with comm.issue_scope("g1"):
            comm.plan_for(AR, torch.zeros((256, 256)))
    assert len(comm.family_recorders("train")) == 3
    c0 = comm.recorder("train/g0").issued_calls()
    c1 = comm.recorder("train/g1").issued_calls()
    assert len(c0) == 1 and len(c1) == 1
    assert {n for _, n, _w in c0}.isdisjoint({n for _, n, _w in c1})
    assert not comm.recorder("train").issued_calls()
    (w0,), (w1,) = {w for *_, w in c0}, {w for *_, w in c1}
    assert w0 == w1
    assert comm.window_population(w0) == 2.0
    comm.await_barrier()
    with comm.recording(comm.recorder("train"), name="train"):
        with comm.issue_scope("g0"):
            comm.plan_for(AR, torch.zeros((512, 512)))
    w2 = comm.recorder("train/g0").issued_calls()[-1][2]
    assert w2 != w0
    assert comm.window_population(w2) == 1.0
    comm.observe_recorders(comm.family_recorders("train"))


def test_unregister_drops_issue_subrecorders(fresh_comms):
    comm = comm_init_rank("x", 8, CommConfig(profile="h800"))
    comm.register_recorder("p")
    with comm.recording(comm.recorder("p"), name="p"):
        with comm.issue_scope("g0"):
            comm.plan_for(AR, torch.zeros((64, 64)))
    assert "p/g0" in comm._recorders
    comm.unregister_recorder("p")
    assert "p/g0" not in comm._recorders and "p" not in comm._recorders


@pytest.mark.parametrize("remat", [False, True])
def test_leaf_hook_fires_once_with_the_summed_gradient(remat):
    """What ``backward_issuing`` relies on: under ``torch.autograd.grad``
    a tensor hook on a leaf used many times (a stacked [L, ...] leaf
    sliced per layer, as the model does, optionally under the per-layer
    checkpoint) fires ONCE, with the summed gradient, and returning None
    leaves the gradient ``grad`` returns unchanged."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.train.train_step import backward_issuing
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3, 4, 4), generator=gen, requires_grad=True)
    b = torch.randn((4,), generator=gen, requires_grad=True)
    x = torch.randn((2, 4), generator=gen)

    def layer(wi, h):
        return torch.tanh(h @ wi + b)

    def loss_fn():
        h = x
        for i in range(3):
            h = (checkpoint(layer, w[i], h, use_reentrant=False) if remat
                 else layer(w[i], h))
        return (h * h).sum()

    seen = []
    run = SimpleNamespace(ready=lambda i, g: seen.append((i, g)))
    got = backward_issuing(loss_fn(), [w, b], run)
    want = torch.autograd.grad(loss_fn(), [w, b])
    assert sorted(i for i, _ in seen) == [0, 1]
    for i, g in seen:
        assert g is got[i] or torch.equal(g, got[i])
        torch.testing.assert_close(g, want[i], rtol=0, atol=0)
    # an exception in a hook fails the backward
    boom = SimpleNamespace(ready=lambda i, g: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        backward_issuing(loss_fn(), [w, b], boom)
    assert not w._backward_hooks


def test_issue_without_communicators_is_a_no_op():
    from repro_torch.models.tp import ParallelCtx
    ctx = ParallelCtx()
    with ctx.issue("g0"):
        pass
    assert ctx.side_stream is None
    tree = {"a": torch.ones(2)}
    assert ctx.await_all(tree) is tree
