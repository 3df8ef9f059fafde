"""The port's FlexCommunicator against the JAX reference.

Control plane, in this process: after the same call sequence the port's
``plan_signature()`` and ``report()`` equal the reference's, the
TuningProfile JSON it saves is byte-identical, and a cold -> save -> warm
cycle runs zero Stage-1 iterations.

Data plane, on 8 gloo ranks in ONE spawn (rank side in
``_torch_ranks.py``, which never imports JAX): the communicator's
all-reduce / all-gather / reduce-scatter / all-to-all / broadcast on a
(4, 2) mesh, warm-started with multi-path shares so that small payloads
take mixed plans, equal the reference communicator's under ``shard_map``
exactly (small-integer payloads); and a measured-timing data-parallel
StepProgram loop whose ranks read skewed clocks keeps one plan on every
rank at every step.
"""

import json

import numpy as np
import pytest
import torch

import _torch_ranks
from repro.core import communicator as j_comm
from repro.core.topology import Collective as JColl
from repro_torch.core import communicator as t_comm
from repro_torch.core.topology import Collective as TColl
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.tp import ParallelCtx, single_device_ctx

MiB = 1 << 20
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
WARM_SHARES = {"nvlink": 60, "pcie": 25, "rdma": 15}
MEASURED_STEPS = 40


@pytest.fixture(autouse=True)
def _fresh_comms():
    j_comm.comm_destroy_all()
    t_comm.comm_destroy_all()
    yield
    j_comm.comm_destroy_all()
    t_comm.comm_destroy_all()


def _calls(n_bytes_list):
    """Payload stand-ins with only a size: the reference reads shape and
    dtype, the port numel and element size."""
    import jax
    import jax.numpy as jnp
    return [(jax.ShapeDtypeStruct((n // 4,), jnp.float32),
             torch.empty((n // 4,), device="meta")) for n in n_bytes_list]


SIZES = (4 * 1024, 3 * MiB, 64 * MiB, 256 * MiB, 1024 * MiB)


def _drive(jc, tc):
    """The same call sequence on both communicators: every op at every
    size, then Stage-2 windows over the default recorder."""
    for jx, tx in _calls(SIZES):
        for op in OPS:
            jc.plan_for(JColl(op), jx)
            tc.plan_for(TColl(op), tx)
    for _ in range(30):
        assert tc.observe_executed_step() == jc.observe_executed_step()


@pytest.mark.parametrize("profile", ["h800", "h100", "a800", "gb200"])
@pytest.mark.parametrize("n,ortho", [(2, "model"), (4, None), (8, "model")])
def test_plan_signature_and_report_equal_reference(profile, n, ortho):
    cfg = dict(profile=profile, measurement_noise=0.05, seed=3)
    jc = j_comm.FlexCommunicator("data", n, j_comm.CommConfig(**cfg), ortho)
    tc = t_comm.FlexCommunicator("data", n, t_comm.CommConfig(**cfg), ortho)
    _drive(jc, tc)
    plain = _torch_ranks.plain_signature
    assert plain(tc.plan_signature()) == plain(jc.plan_signature())
    assert json.dumps(tc.report(), sort_keys=True, default=str) == \
        json.dumps(jc.report(), sort_keys=True, default=str)
    assert tc.tuning_status() == jc.tuning_status()


@pytest.mark.parametrize("profile", ["h800", "h100"])
def test_tuning_profile_json_is_byte_identical(profile, tmp_path):
    paths = {}
    for name, mod in (("ref", j_comm), ("port", t_comm)):
        paths[name] = tmp_path / f"{name}.json"
        comm = mod.FlexCommunicator(
            "data", 8, mod.CommConfig(profile=profile,
                                      tuning_cache=str(paths[name])))
        for jx, tx in _calls(SIZES):
            for op in ("all_reduce", "all_gather"):
                coll = JColl if mod is j_comm else TColl
                comm.plan_for(coll(op), jx if mod is j_comm else tx)
        assert comm.save_tuning() == 2 * len(SIZES)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()


def test_cold_save_warm_runs_zero_stage1_iterations(tmp_path):
    path = str(tmp_path / "prof.json")
    calls = [tx for _, tx in _calls((512 * 1024, 16 * MiB, 256 * MiB))]
    cold = t_comm.comm_init_rank("data", 8, t_comm.CommConfig(
        profile="h100", tuning_cache=path))
    for x in calls:
        cold.plan_for(TColl.ALL_GATHER, x)
        cold.plan_for(TColl.ALL_REDUCE, x)
    assert all(sc.tuned.iterations > 0 and not sc.warm
               for sc in cold._slots.values())
    sig = cold.plan_signature()
    assert cold.save_tuning() == 6
    t_comm.comm_destroy_all()
    warm = t_comm.comm_init_rank("data", 8, t_comm.CommConfig(
        profile="h100", tuning_cache=path))
    assert warm is not cold
    for x in calls:
        warm.plan_for(TColl.ALL_GATHER, x)
        warm.plan_for(TColl.ALL_REDUCE, x)
    assert all(sc.tuned.iterations == 0 and sc.warm
               for sc in warm._slots.values())
    assert warm.plan_signature() == sig


def test_default_profile_is_h100_and_compress_raises():
    """The default profile is h100; a compress spec is validated when the
    communicator is built (a bad one raises there, as the reference's
    does), and a good one yields codec-carrying plans."""
    assert t_comm.CommConfig().profile == "h100"
    for bad in ("primary=fp8", "secondary=fp9", "fp8"):
        with pytest.raises(ValueError):
            t_comm.FlexCommunicator("data", 4,
                                    t_comm.CommConfig(compress=bad))
    comp = t_comm.FlexCommunicator(
        "data", 4, t_comm.CommConfig(compress="secondary=fp8"))
    assert comp._bucket_plan(TColl.ALL_REDUCE, 1024 * MiB).path_codecs == \
        (("staged", "fp8_e4m3"),)
    comm = t_comm.FlexCommunicator("data", 4)
    with pytest.raises(RuntimeError, match="no mesh"):
        comm.all_reduce(torch.zeros(8))


@pytest.mark.parametrize("field,item", [("node_size", "item 12"),
                                        ("pod_size", "item 14")])
def test_parallel_ctx_names_what_still_raises(field, item):
    """The node axis (ported by ROADMAP item 12) and the pod axis (item
    14): like every axis wider than 1 each needs the rank's mesh."""
    axis = field.removesuffix("_size")
    with pytest.raises(ValueError, match="needs the rank's mesh"):
        ParallelCtx(**{f"{axis}_axis": axis, field: 2})


def test_parallel_ctx_one_device_and_data_axis_without_mesh():
    ctx = single_device_ctx()
    assert ctx.comms() == () and ctx.plan_signature() == ()
    grads = {"w": torch.ones(3)}
    assert ctx.grad_all_reduce(grads) is grads
    with pytest.raises(ValueError, match="mesh"):
        ParallelCtx(dp_axis="data", dp_size=4)
    with pytest.raises(ValueError, match="mesh"):
        ParallelCtx(tp_axis="model", tp_size=2)


# ---------------------------------------------------------------------------
# the data plane on 8 gloo ranks
# ---------------------------------------------------------------------------

def _ints(shape, seed):
    return np.random.default_rng(seed).integers(0, 31, shape).astype(
        np.float32)


# name -> (communicator method, global input, in spec, out spec, kwargs)
PAYLOADS = {
    "all_reduce": ("all_reduce", _ints((4 * 6, 5), 0), "data", "data", {}),
    "all_reduce_big": ("all_reduce", _ints((4 * 1000, 9), 1), "data",
                       "data", {}),
    "all_gather": ("all_gather", _ints((4 * 3, 7), 2), "data", "none", {}),
    "reduce_scatter": ("reduce_scatter", _ints((4 * 8, 3), 3), "none",
                       "data", {}),
    "all_to_all": ("all_to_all", _ints((4 * 8, 5), 4), "data", "data", {}),
    "all_to_all_axis1": ("all_to_all", _ints((4 * 3, 8), 5), "data", "data",
                         {"split_axis": 1, "concat_axis": 1}),
    "broadcast": ("broadcast", _ints((4 * 2, 3), 6), "data", "data",
                  {"root": 1}),
}


def _warm_profile(path):
    """A TuningProfile that gives the 1 MiB bucket of every op a
    three-path split, so tiny test payloads take mixed plans."""
    from repro.control import TuningProfile
    prof = TuningProfile(str(path))
    for op in OPS:
        for n in (4, 8):
            prof.record("h800", "ring", JColl(op), n, MiB, 100, WARM_SHARES)
    prof.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    path = _warm_profile(tmp_path_factory.mktemp("tuning") / "warm.json")
    payloads = {k: (op, x, ins, kw) for k, (op, x, ins, _o, kw)
                in PAYLOADS.items()}
    saves = tmp_path_factory.mktemp("saved")
    results = run_ranks(_torch_ranks.communicator, 8, backend="gloo",
                        device="cpu", timeout_s=240,
                        args=(path, payloads, MEASURED_STEPS, str(saves)))
    return path, results


def _reference(path, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    op, x, ins, outs, kw = PAYLOADS[name]
    comm = j_comm.comm_init_rank("data", 4, j_comm.CommConfig(
        profile="h800", tuning_cache=path), ortho_name="model")
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    spec = {"data": P("data"), "none": P()}
    f = shard_map(lambda v: getattr(comm, op)(v, **kw), mesh=mesh,
                  in_specs=(spec[ins],), out_specs=spec[outs],
                  check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x))), comm


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_communicator_data_plane_matches_reference(ranked, name):
    path, results = ranked
    want, comm = _reference(path, name)
    outs = PAYLOADS[name][3]
    for r, res in enumerate(results):
        d = r // 2
        exp = want if outs == "none" else \
            want[d * want.shape[0] // 4:(d + 1) * want.shape[0] // 4]
        np.testing.assert_array_equal(res[name], exp, err_msg=f"rank {r}")
    plan = comm._bucket_plan(JColl(PAYLOADS[name][0]), MiB) \
        if name != "broadcast" else None
    if plan is not None:
        assert not plan.is_primary_only, "the warm start must route mixed"


def test_plan_signature_equal_across_ranks_and_reference(ranked):
    path, results = ranked
    comm = j_comm.comm_init_rank("data", 4, j_comm.CommConfig(
        profile="h800", tuning_cache=path), ortho_name="model")
    import jax.numpy as jnp
    for name, (op, x, ins, _o, kw) in PAYLOADS.items():
        if op == "broadcast":
            continue
        local = x if ins == "none" else x[: x.shape[0] // 4]
        comm.plan_for(JColl(op), jnp.asarray(local))
    want = _torch_ranks.plain_signature(comm.plan_signature())
    assert all(res["signature"] == want for res in results)


def test_measured_plans_agree_across_ranks(ranked):
    """Each rank's clock reads another step time; max-reduced over the
    axis group, every rank's balancer takes the same decisions, so the
    plan signature agrees on every rank at every step — and it moves."""
    _, results = ranked
    runs = [res["measured"] for res in results]
    assert all(m["timing"] == "measured" for m in runs)
    sigs = [m["signatures"] for m in runs]
    assert len(sigs[0]) == MEASURED_STEPS
    assert all(s == sigs[0] for s in sigs[1:])
    assert len(set(sigs[0])) > 1, "no share moved in the measured loop"
    assert runs[0]["report"]["plan_rekeys"] > 0


def test_grad_all_reduce_sums_over_the_data_axis(ranked):
    _, results = ranked
    want_w = np.full((64, 8), float(sum(range(8))), np.float32)
    want_b = np.arange(8, dtype=np.float32) * sum(r + 1 for r in range(8))
    for res in results:
        g = res["measured"]["grads"]
        np.testing.assert_array_equal(g["w"], want_w)
        np.testing.assert_array_equal(g["b"], want_b)


def test_every_rank_saves_the_same_tuning_profile(ranked):
    """After the measured loop each rank's ``save_tuning_profile`` writes
    the one slot it tuned, and the files are byte-identical."""
    _, results = ranked
    saved = [res["measured"]["saved"] for res in results]
    assert all(n == 1 for n, _ in saved)
    blobs = [open(path, "rb").read() for _, path in saved]
    assert all(b == blobs[0] for b in blobs[1:])
