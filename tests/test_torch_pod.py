"""The port's pod tier against the JAX reference (DESIGN.md §15,
tests/test_pod.py).

In this process, with ``==``: the copied three-tier topology and timing
model against the reference's (the registered pod tier, the pods=1
pinning, spine degrades), a spine fault's committed transition on a
pod-tier communicator, ``resolve_faults``' spine validation, and the
launchers' pod flags (``--pods`` without ``--nodes`` and a node loss
with ``--pods`` refused before any spawn, the serve launcher's registered
three-tier topology).

On gloo ranks, spawned once for the module (8 ranks; rank side
``_torch_ranks.pod``, which imports no JAX) while the reference runs
here under ``shard_map`` on the conftest's 8 CPU devices, from the same
small-integer payloads (every partial sum exact, so any summation order
gives the same bits), each rank's output against the reference's output
for that rank, bit for bit:

* the three-tier all-reduce, all-gather and reduce-scatter on every
  layout of test_pod.py's ``_GRID3``, f32 and bf16, every tier pinned to
  multi-route shares, with equal plan signatures; the reduce-scatter's
  ``(i * n + node) * p + pod`` segments and the all-gather's
  outermost-major order, also against the host's exact result;
* the rail-local ``ep_all_to_all`` against the reference's flat
  ``lax.all_to_all`` over (pod, node, data) and the port's flat one over
  the mesh's plane group, f32 and bf16, and its a2a report; the two-tier
  (node=2, data=4) degeneration;
* the pods=1 cluster against the two-tier one: outputs and plan
  signatures, equal to the reference's;
* the ctx on (pod=2, node=2, data=2, model=1) and on the legacy (pod=2,
  data=2, model=1) mesh: comms, ep span, gradient reduce, plan
  signature and reports;
* reduced glm4-9b and reduced Kimi-K2 (8 experts, ep_a2a over the
  three-tier span) trained 3 steps on (pod=2, node=2, data=2, model=1),
  within 5e-3 of the reference's step on the same mesh, built without
  donation (ROADMAP queue 3; tests/test_torch_cluster.py builds its
  cluster step the same way).

One train launcher run on 4 gloo ranks, ``--pods 2 --nodes 2
--mesh-shape 1,1``, runs beside them.
"""

import dataclasses
import enum
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import _torch_ranks
from repro.cluster import simulator as j_csim
from repro.cluster import topology as j_topo
from repro.compat import shard_map
from repro.configs import clusters as j_clusters
from repro.core import communicator as j_comm
from repro.core.topology import Collective as JColl
from repro_torch.cluster import simulator as t_csim
from repro_torch.cluster import topology as t_topo
from repro_torch.configs import clusters as t_clusters
from repro_torch.core import communicator as t_comm
from repro_torch.core.topology import Collective as TColl
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import run_ranks

EP_AXES = ("pod", "node", "data")
#: test_pod.py's (pods, nodes a pod, ranks a node) layouts: absent intra
#: (m=1), absent inter (n=1) and all tiers live
GRID3 = [(2, 2, 2), (2, 1, 4), (2, 4, 1), (4, 2, 1), (4, 1, 2)]
DTYPES = ("float32", "bfloat16")
OPS = ("all_reduce", "all_gather", "reduce_scatter")
#: pinned shares a tier (the warm-start cache both packages read)
SHARES = {"intra": {"nvlink": 60, "pcie": 40, "rdma": 0},
          "inter": {"rail": 50, "xrail": 25, "host_tcp": 25},
          "pod": {"spine": 50, "xspine": 25, "pod_tcp": 25}}
STEPS = 3
TRAIN = {"dense": {"arch": "glm4-9b", "reduced": {}},
         "kimi": {"arch": "kimi-k2-1t-a32b", "reduced": {"n_experts": 8}}}
#: the reference's own bound on cluster training against a reference run
#: (tests/test_cluster.py test_multi_node_train_matches_single_node)
TRAIN_ATOL = 5e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = ["--smoke", "--device", "cpu", "--dist", "gloo", "--steps", "2",
          "--pods", "2", "--nodes", "2", "--mesh-shape", "1,1"]


def plain(obj):
    """Framework-neutral form for ``==``: dataclasses and enums of either
    package become tuples and values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return tuple(sorted((plain(k), plain(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(plain(v) for v in obj)
    return obj


@pytest.fixture(autouse=True)
def _fresh_comms():
    j_comm.comm_destroy_all()
    t_comm.comm_destroy_all()
    yield
    j_comm.comm_destroy_all()
    t_comm.comm_destroy_all()


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(0, 8, size=shape).astype(
        np.float32)


def _name(layout, dtype):
    return "x".join(map(str, layout)) + f"-{dtype}"


def _coll_cases():
    cases = {}
    for k, layout in enumerate(GRID3):
        for j, dt in enumerate(DTYPES):
            c = {"layout": layout, "dtype": dt,
                 "x": _ints((8 * 8, 3), 10 * k + j),
                 # the all-reduce's per-rank length (15) pads to the lower
                 # tiers' multiple
                 "x_ar": _ints((8 * 5, 3), 10 * k + j + 100)}
            if layout == (2, 2, 2):
                c["x_a2a"] = np.random.default_rng(3 + j).normal(
                    size=(8 * 16, 3)).astype(np.float32)
            cases[_name(layout, dt)] = c
    return cases


def _tier_profiles():
    topo = t_topo.make_cluster("h800", 2, nics_per_node=4, nic_gbit=400.0,
                               pods=2, pod_uplinks=4, pod_gbit=400.0)
    return {"intra": "h800", "inter": topo.nic_tier.name,
            "pod": topo.pod_tier.name}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod")
    cache = str(d / "pinned.json")
    for tier, profile in _tier_profiles().items():
        for n in (2, 4):
            _torch_ranks.pinned_profile(cache, profile, n, SHARES[tier],
                                        ops=OPS + ("all_to_all",))
    return {"cache": cache, "dir": d}


@pytest.fixture(scope="module")
def inits():
    from repro.configs import get_config
    from repro.models import init_params
    out = {}
    for name, run in TRAIN.items():
        cfg = get_config(run["arch"]).reduced(**run["reduced"])
        out[name] = jax.tree.map(np.asarray,
                                 init_params(jax.random.PRNGKey(0), cfg))
    return out


def _case(work, inits):
    return {"cache": work["cache"], "coll": _coll_cases(),
            "a2a2": {"x": np.random.default_rng(5).normal(
                size=(8 * 8, 2)).astype(np.float32)},
            "parity": {"f32": {"x": _ints((8 * 16, 3), 1)}},
            "ctx": {"x": _ints((8 * 16, 3), 2)},
            "legacy": {"x": _ints((4 * 16, 3), 4)},
            "train": {name: dict(run, params=inits[name], steps=STEPS)
                      for name, run in TRAIN.items()}}


@pytest.fixture(scope="module")
def bg(work, inits):
    """The port's 8 ranks and the launcher run, started in the background
    while the reference's fixtures run here; each test waits for what it
    reads."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = str(work["dir"] / "launch.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--out", out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, _torch_ranks.pod, 8, backend="gloo",
                          device="cpu", timeout_s=600,
                          args=(_case(work, inits),))
        yield {"ranks": ranks, "launch": (proc, out)}
        ranks.result()
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def port(bg, reference, ref_parity, ref_ctx, ref_legacy, ref_train):
    """The ranks' results, read once every reference result is built (the
    reference runs while the ranks do)."""
    return bg["ranks"].result()


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _ref_comm3(layout, cache, tag):
    """tests/test_pod.py's ``_comm3``, warm-started from ``cache``."""
    from repro.cluster.communicator import ClusterCommunicator
    p, n, m = layout
    topo = j_topo.make_cluster("h800", n, nics_per_node=4, nic_gbit=400.0,
                               pods=p, pod_uplinks=4, pod_gbit=400.0)
    cfg = j_comm.CommConfig
    intra = (j_comm.FlexCommunicator("data", m, cfg(
        profile="h800", tuning_cache=cache, tag=f"{tag}-intra"))
        if m > 1 else None)
    inter = (j_comm.FlexCommunicator("node", n, cfg(
        profile=topo.nic_tier.name, tuning_cache=cache, tag=f"{tag}-inter"),
        ortho_name="data" if m > 1 else None) if n > 1 else None)
    pod = (j_comm.FlexCommunicator("pod", p, cfg(
        profile=topo.pod_tier.name, tuning_cache=cache, tag=f"{tag}-pod"),
        ortho_name="node" if n > 1 else None) if p > 1 else None)
    return ClusterCommunicator(topo, intra, inter, pod)


def _sig(comm):
    return tuple((a, _torch_ranks.plain_signature(s))
                 for a, s in comm.plan_signature())


def _f32(a):
    return np.asarray(a.astype(jnp.float32))


@pytest.fixture(scope="module")
def reference(work, bg):
    """Each collective case's global outputs and plan signatures, from ONE
    shard_map of the reference's ClusterCommunicator per case."""
    out = {}
    spec = P(EP_AXES)
    for name, c in _coll_cases().items():
        j_comm.comm_destroy_all()
        cc = _ref_comm3(c["layout"], work["cache"], name)
        a2a = "x_a2a" in c

        def run(x, xa, *xe, cc=cc):
            got = {"all_reduce": cc.all_reduce(xa),
                   "all_gather": cc.all_gather(x, tiled=True),
                   "reduce_scatter": cc.reduce_scatter(x)}
            if xe:
                got["a2a"] = cc.ep_all_to_all(xe[0], 0, 0)
                got["a2a_flat"] = lax.all_to_all(xe[0], EP_AXES, 0, 0,
                                                 tiled=True)
            return got

        out_specs = {op: P() if op == "all_gather" else spec
                     for op in OPS + (("a2a", "a2a_flat") if a2a else ())}
        f = jax.jit(shard_map(run, mesh=_jmesh(c["layout"], EP_AXES),
                              in_specs=(spec,) * (3 if a2a else 2),
                              out_specs=out_specs, check_vma=False))
        dt = jnp.dtype(c["dtype"])
        args = [jnp.asarray(c[k]).astype(dt)
                for k in ("x", "x_ar", "x_a2a") if k in c]
        out[name] = {op: _f32(v) for op, v in f(*args).items()}
        out[name]["signature"] = _sig(cc)
        if a2a:
            out[name]["a2a_report"] = cc.a2a_report()
    j_comm.comm_destroy_all()
    return out


def _exact(layout, op, x, x_ar):
    """The exact result for rank r = (pod, node, i) of the flat reduction
    or gather over (pod, node, data), from the host."""
    p, n, m = layout
    world = p * n * m
    if op == "all_reduce":
        return [sum(np.split(x_ar, world))] * world
    if op == "all_gather":
        return [x] * world
    seg = np.split(sum(np.split(x, world)), world)
    return [seg[((r % m) * n + (r // m) % n) * p + r // (m * n)]
            for r in range(world)]


COLL = [(name, op) for name in _coll_cases() for op in OPS]


@pytest.mark.parametrize("name,op", COLL)
def test_three_tier_collectives_bit_exact_vs_reference(port, reference, name,
                                                       op):
    """test_pod.py:209-308 on every _GRID3 layout: each rank's output is
    the reference shard_map's output for that rank, and the exact one
    (the reduce-scatter's ``(i * n + node) * p + pod`` segments, the
    outermost-major gather)."""
    c = _coll_cases()[name]
    want = reference[name][op]
    exact = _exact(c["layout"], op, c["x"], c["x_ar"])
    for r, got in enumerate(port):
        g = got["coll"][name][op]
        w = want if op == "all_gather" else np.split(want, 8)[r]
        np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
        np.testing.assert_array_equal(g, exact[r].astype(g.dtype),
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("layout", GRID3, ids=lambda t: "x".join(map(str, t)))
def test_three_tier_plan_signatures_equal_reference(port, reference, layout):
    for dt in DTYPES:
        name = _name(layout, dt)
        for r, got in enumerate(port):
            assert got["coll"][name]["signature"] == \
                reference[name]["signature"], f"{name} rank {r}"
    sig = dict(reference[_name(layout, "float32")]["signature"])
    p, n, m = layout
    assert set(sig) == {a for a, k in zip(EP_AXES, layout) if k > 1}
    # the pinned pod tier runs every route when the node axis is its
    # ortho detour, primary and staged without it
    for *_, plan in sig["pod"]:
        units = dict(dict(plan)["chunk_units"])
        assert {k for k, u in units.items() if u} >= {"primary", "staged"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_ep_all_to_all_bit_exact_vs_flat(port, reference, dtype):
    """test_pod.py:315-333: the rail-local decomposition equals the flat
    all_to_all over (pod, node, data), the reference's and the port's over
    the plane group, bit for bit on every rank."""
    name = _name((2, 2, 2), dtype)
    want = np.split(reference[name]["a2a_flat"], 8)
    np.testing.assert_array_equal(reference[name]["a2a"],
                                  reference[name]["a2a_flat"])
    for r, got in enumerate(port):
        c = got["coll"][name]
        np.testing.assert_array_equal(c["a2a"], want[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(c["a2a_flat"], want[r])


def test_ep_all_to_all_two_tier_matches_flat(port):
    """test_pod.py:336-357: with no pod tier the decomposition equals the
    flat all_to_all over (node, data)."""
    x = np.random.default_rng(5).normal(size=(8 * 8, 2)).astype(np.float32)
    f = jax.jit(shard_map(
        lambda v: lax.all_to_all(v, ("node", "data"), 0, 0, tiled=True),
        mesh=_jmesh((2, 4), ("node", "data")), in_specs=(P(("node",
                                                            "data")),),
        out_specs=P(("node", "data")), check_vma=False))
    want = np.split(np.asarray(f(jnp.asarray(x))), 8)
    for r, got in enumerate(port):
        np.testing.assert_array_equal(got["a2a2"]["a2a"], want[r])
        np.testing.assert_array_equal(got["a2a2"]["flat"], want[r])


def test_ep_a2a_reports_rail_local_bytes(port, reference):
    """test_pod.py:360-374: the a2a block counts intra, rail-local and
    spine bytes, equal to the reference's, and the rollup has every
    tier."""
    name = _name((2, 2, 2), "float32")
    for got in port:
        c = got["coll"][name]
        rep = c["a2a_report"]
        assert rep["intra_bytes"] > 0
        assert rep["rail_local_bytes"] + rep["spine_bytes"] > 0
        assert rep == reference[name]["a2a_report"]
        s = json.loads(c["summary"])
        assert set(s["rollup"]) == {"intra", "inter", "pod"}
        assert s["a2a"]["rail_local_bytes"] == rep["rail_local_bytes"]


@pytest.fixture(scope="module")
def ref_parity():
    from repro.cluster.communicator import ClusterCommunicator
    mesh = _jmesh((2, 4), ("node", "data"))

    def two_tier(tag, topo):
        intra = j_comm.FlexCommunicator("data", 4, j_comm.CommConfig(
            profile="h800", tag=f"{tag}-intra"))
        inter = j_comm.FlexCommunicator("node", 2, j_comm.CommConfig(
            profile=topo.nic_tier.name, tag=f"{tag}-inter"),
            ortho_name="data")
        return ClusterCommunicator(topo, intra, inter)

    j_comm.comm_destroy_all()
    ccs = (two_tier("par-a", j_topo.make_cluster("h800", 2)),
           two_tier("par-b", j_topo.make_cluster("h800", 2, pods=1)))
    x = _ints((8 * 16, 3), 1)
    spec = P(("node", "data"))
    outs = []
    for cc in ccs:
        f = jax.jit(shard_map(lambda v, cc=cc: {
            "all_reduce": cc.all_reduce(v),
            "all_gather": cc.all_gather(v, tiled=True),
            "reduce_scatter": cc.reduce_scatter(v)}, mesh=mesh,
            in_specs=(spec,), out_specs={"all_reduce": spec,
                                         "all_gather": P(),
                                         "reduce_scatter": spec},
            check_vma=False))
        outs.append({k: np.asarray(v) for k, v in f(x).items()})
    out = {"out": outs, "signature": [_sig(cc) for cc in ccs]}
    j_comm.comm_destroy_all()
    return out


@pytest.mark.parametrize("op", OPS)
def test_pods1_cluster_is_the_two_tier_one(port, ref_parity, op):
    """test_pod.py:168-202: a pods=1 cluster builds no pod communicator,
    executes and signs exactly like the two-tier one; both equal the
    reference's."""
    for r, got in enumerate(port):
        c = got["parity"]["f32"]
        assert c["pod"]
        a, b = c["out"]
        np.testing.assert_array_equal(a[op], b[op])
        w = ref_parity["out"][1][op]
        np.testing.assert_array_equal(
            a[op], w if op == "all_gather" else np.split(w, 8)[r])
        assert c["signature"][0] == c["signature"][1] == \
            ref_parity["signature"][1] == ref_parity["signature"][0]


@pytest.fixture(scope="module")
def ref_ctx():
    """test_pod.py:381-410's ctx on (pod=2, node=2, data=2, model=1)."""
    from repro.models.tp import ParallelCtx as JCtx
    j_comm.comm_destroy_all()
    ctx = JCtx(tp_axis="model", dp_axis="data", node_axis="node",
               pod_axis="pod", tp_size=1, dp_size=2, node_size=2,
               pod_size=2, comm_config=j_comm.CommConfig(profile="h800",
                                                         tag="ctx-pod"))
    x = _ints((8 * 16, 3), 2)
    spec = P(EP_AXES)
    f = jax.jit(shard_map(lambda v: ctx.grad_all_reduce({"w": v})["w"],
                          mesh=_jmesh((2, 2, 2, 1), EP_AXES + ("model",)),
                          in_specs=(spec,), out_specs=spec, check_vma=False))
    y = np.asarray(f(jnp.asarray(x)))
    rep = ctx.comm_report()
    out = {"y": y, "axes": [c.axis_name for c in ctx.comms()],
           "signature": _sig(ctx),
           "tiers": {a: rep[a]["tier"] for a in rep if a != "cluster"},
           "cluster": json.dumps(rep["cluster"], sort_keys=True,
                                 default=str),
           "ep": (ctx.ep_axes, ctx.ep_size, ctx.ep_spec_axis())}
    j_comm.comm_destroy_all()
    return out


@pytest.mark.parametrize("what", ["y", "axes", "signature", "tiers",
                                  "cluster", "ep"])
def test_ctx_pod_axis_matches_reference(port, ref_ctx, what):
    """The ctx's pod communicator, ep span (pod, node, data) of 8, comms
    order data, node, pod, three-tier gradient reduce bit for bit, plan
    signature and report, on every rank, equal to the reference's."""
    want = ref_ctx[what]
    for r, got in enumerate(port):
        c = got["ctx"]
        assert c["pod_comm"] and c["n_pods"] == 2
        if what == "y":
            np.testing.assert_array_equal(c["y"], np.split(want, 8)[r])
        elif what == "ep":
            axes, size, spec, index = c["ep"]
            assert (tuple(axes), size, tuple(spec)) == want
            assert want == (EP_AXES, 8, EP_AXES) and index == r
        else:
            assert c[what] == want, f"rank {r}"


def test_ctx_pod_report_and_metrics(port):
    got = port[0]["ctx"]
    assert got["axes"] == ["data", "node", "pod"]
    assert [s[0] for s in got["signature"]] == ["data", "node", "pod"]
    assert got["tiers"] == {"data": "intra", "node": "inter", "pod": "pod"}
    roll = json.loads(got["cluster"])["rollup"]
    assert set(roll) == {"intra", "inter", "pod"}
    assert roll["pod"]["slots"] >= 1
    x = _ints((8 * 16, 3), 2)
    for c in port:
        m = c["ctx"]["metrics"]
        np.testing.assert_array_equal(m["loss"], m["nested"])
        assert float(m["loss"]) == float(x.sum())
        assert float(m["lr"]) == pytest.approx(0.5)


@pytest.fixture(scope="module")
def ref_legacy(work):
    """The reference's ctx on the legacy (pod=2, data=2, model=1) mesh:
    the data tier's flex reduce, then a plain pod psum."""
    from repro.models.tp import ParallelCtx as JCtx
    j_comm.comm_destroy_all()
    ctx = JCtx(tp_axis="model", dp_axis="data", pod_axis="pod", tp_size=1,
               dp_size=2, pod_size=2, comm_config=j_comm.CommConfig(
                   profile="h800", tuning_cache=work["cache"],
                   tag="legacy"))
    spec = P(("pod", "data"))
    f = jax.jit(shard_map(lambda v: (ctx.grad_all_reduce({"w": v})["w"],
                                     ctx.expert_grad_reduce(v)),
                          mesh=_jmesh((2, 2, 1), ("pod", "data", "model")),
                          in_specs=(spec,), out_specs=(spec, spec),
                          check_vma=False))
    y, e = f(jnp.asarray(_ints((4 * 16, 3), 4)))
    out = {"y": np.asarray(y), "expert": np.asarray(e),
           "signature": _sig(ctx), "ep": (ctx.ep_axes, ctx.ep_size),
           "pod_comm": ctx._pod_comm is not None}
    j_comm.comm_destroy_all()
    return out


def test_legacy_pod_mesh_reduces_as_the_reference(port, ref_legacy):
    """A pod axis without a node axis has no communicator: the gradient
    reduce is the data tier's flex all-reduce and a plain pod psum, the
    expert reduce a plain pod psum, bit for bit the reference's on ranks
    0-3 (the mesh spans those ranks only)."""
    assert not ref_legacy["pod_comm"]
    x = _ints((4 * 16, 3), 4)
    for r, got in enumerate(port[:4]):
        c = got["legacy"]
        assert not c["pod_comm"] and not c["cluster"]
        assert (tuple(c["ep"][0]), c["ep"][1]) == ref_legacy["ep"]
        assert c["signature"] == ref_legacy["signature"]
        np.testing.assert_array_equal(c["y"], np.split(ref_legacy["y"], 4)[r])
        np.testing.assert_array_equal(
            c["expert"], np.split(ref_legacy["expert"], 4)[r])
        np.testing.assert_array_equal(c["y"], sum(np.split(x, 4)))
    assert all("legacy" not in got for got in port[4:])


# ---------------------------------------------------------------------------
# training on (pod=2, node=2, data=2, model=1)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_train(inits, bg):
    """The reference's train step on (pod=2, node=2, data=2, model=1),
    built as launch/steps.py builds it but jitted without donation, STEPS
    steps of each TRAIN run."""
    from repro.configs import get_config
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch import steps as JS
    from repro.launch.mesh import make_cluster_mesh
    from repro.models.transformer import param_specs
    from repro.optim.adamw import AdamWConfig, init_state
    from repro.train.train_step import make_train_step
    out = {}
    for name, run in TRAIN.items():
        j_comm.comm_destroy_all()
        cfg = get_config(run["arch"]).reduced(**run["reduced"])
        mesh = make_cluster_mesh(2, 2, 1, pods=2)
        ctx = JS.make_ctx(mesh, j_comm.CommConfig(profile="tpu_v5e",
                                                  tag=name))
        assert ctx._pod_comm is not None
        psp = param_specs(cfg, data_axis=ctx.ep_spec_axis() or "data")
        osp = JS.opt_state_specs(psp)
        step = jax.jit(shard_map(
            make_train_step(cfg, ctx, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=20),
                            remat=True),
            mesh=mesh, in_specs=(psp, osp, JS._batch_specs(
                cfg, SH.InputShape("t", "train", 32, 8), mesh)),
            out_specs=(psp, osp, P()), check_vma=False))
        params = jax.tree.map(jnp.asarray, inits[name])
        opt_state = init_state(params)
        batches = make_batches(cfg, seq_len=32, batch_per_shard=8, seed=7)
        losses = []
        with mesh:
            for _ in range(STEPS):
                params, opt_state, m = step(
                    params, opt_state,
                    {k: jnp.asarray(v) for k, v in next(batches).items()})
                losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "ep": (ctx.ep_axes, ctx.ep_size)}
    j_comm.comm_destroy_all()
    return out


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_three_tier_training_matches_reference(port, ref_train, inits,
                                               name):
    """Every rank's losses equal, finite, falling and within 5e-3 of the
    reference's undonated three-tier step; the gradient sync ran every
    tier.  Kimi-K2's ep_a2a span is (pod, node, data) of 8, and rank r's
    expert shard is block r (its combined ep index) of the reference's
    initial params."""
    runs = [got["train"][name] for got in port]
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    losses = runs[0]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref_train[name]["losses"],
                               atol=TRAIN_ATOL)
    for r, run in enumerate(runs):
        assert run["axes"] == ["data", "node", "pod"]
        assert run["tiers"] == ["inter", "intra", "pod"]
        axes, size, index = run["ep"]
        assert (tuple(axes), size) == ref_train[name]["ep"]
        if name != "kimi":
            continue
        assert tuple(axes) == EP_AXES and size == 8 and index == r
        experts = inits[name]["layers"]["moe"]["experts"]
        for k, v in run["experts"].items():
            np.testing.assert_array_equal(v, experts[k][:, r:r + 1],
                                          err_msg=k)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_train_launcher_runs_three_tiers(bg):
    """``train --pods 2 --nodes 2 --mesh-shape 1,1`` on 4 gloo ranks,
    (pod=2, node=2): the inter and pod tiers, no intra tier; the record
    carries the pod tier and the reference's three-tier topology."""
    proc, path = bg["launch"]
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(path) as f:
        rep = json.load(f)
    assert rep["ranks"] == 4 and len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))
    assert rep["tiers"] == {"node": "inter", "pod": "pod"}
    assert rep["cluster"]["topology"] == \
        j_topo.cluster_for("h100", 2, pods=2).describe()
    assert set(rep["cluster"]["rollup"]) == {"inter", "pod"}


def test_train_launcher_pod_refusals(capsys):
    """``--pods 2`` without ``--nodes`` exits 2 with the reference's
    message; a node loss with ``--pods 2`` exits 2 before any spawn."""
    base = ["--smoke", "--device", "cpu", "--dist", "gloo"]
    assert t_train.main(base + ["--pods", "2", "--mesh-shape", "2,1"]) == 2
    assert t_train.NEEDS_NODES == (
        "--pods > 1 needs a multi-node cluster run (--nodes/--cluster): "
        "the pod tier composes above the NIC tier")
    assert t_train.NEEDS_NODES in capsys.readouterr().err
    assert t_train.main(base + ["--pods", "2", "--nodes", "2",
                                "--mesh-shape", "1,1", "--fault",
                                "node1@step2=down", "--ckpt-dir",
                                "unused"]) == 2
    assert t_train.NODE_LOSS_ON_PODS in capsys.readouterr().err


def test_serve_launcher_registers_three_tiers(tmp_path, capsys):
    rec = tmp_path / "serve.json"
    rc = t_serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--nodes", "2", "--pods", "2",
                       "--out", str(rec)])
    out = capsys.readouterr().out
    assert rc == 0 and "served 2 requests" in out and "2 pods" in out
    assert json.loads(rec.read_text())["cluster"] == \
        j_topo.cluster_for("h100", 2, pods=2).describe()


# ---------------------------------------------------------------------------
# the copies, in this process
# ---------------------------------------------------------------------------

def _pod_cluster(topo, pods, nodes):
    return topo.make_cluster("h800", nodes, nics_per_node=4, nic_gbit=400.0,
                             pods=pods, pod_uplinks=4, pod_gbit=400.0)


@pytest.mark.parametrize("pods,nodes", [(1, 2), (2, 2), (4, 2), (2, 4)])
def test_pod_clusters_equal_reference(pods, nodes):
    t, j = _pod_cluster(t_topo, pods, nodes), _pod_cluster(j_topo, pods,
                                                           nodes)
    assert plain(t) == plain(j) and t.describe() == j.describe()
    assert t.tiers == j.tiers
    if pods > 1:
        assert t.pod_tier.name == j_topo.pod_tier_name("h800", 4, 400.0, 4.0)
    assert plain(t_topo.cluster_for("h100", nodes, pods=pods)) == \
        plain(j_topo.cluster_for("h100", nodes, pods=pods))


@pytest.mark.parametrize("spec", ["spine:spine2=0.25", "rail:rail3=0.25"])
def test_spine_degrades_equal_reference(spec):
    t = t_topo.degrade_cluster(_pod_cluster(t_topo, 2, 2), spec)
    j = j_topo.degrade_cluster(_pod_cluster(j_topo, 2, 2), spec)
    assert plain(t) == plain(j)


def test_three_tier_timing_model_equals_reference():
    tm = t_csim.ClusterTimingModel(_pod_cluster(t_topo, 4, 4), 8)
    jm = j_csim.ClusterTimingModel(_pod_cluster(j_topo, 4, 4), 8)
    for op in OPS:
        for b in (1 << 16, 1 << 24, 256 << 20):
            assert tm.hierarchical_time(TColl(op), b) == \
                jm.hierarchical_time(JColl(op), b)
            assert tm.flat_time(TColl(op), b) == jm.flat_time(JColl(op), b)
    for sched in ("rail_local", "naive", "flat"):
        assert tm.a2a_time(64 << 20, schedule=sched) == \
            jm.a2a_time(64 << 20, schedule=sched)


def _spine_fault(comm_mod, topo_mod, faults, coll, cache):
    """test_pod.py:417-453 in one package: a spine fault commits once on
    the pod-tier communicator and re-keys it warm."""
    cluster = _pod_cluster(topo_mod, 2, 2)
    tier = cluster.pod_tier
    degraded = topo_mod.degrade_cluster(cluster, "spine:spine2=0.25")
    payload = 16 << 20
    for prof in (degraded.pod_tier.name, tier.name):
        c = comm_mod.FlexCommunicator("pod", 2, comm_mod.CommConfig(
            profile=prof, tuning_cache=cache))
        for _ in range(12):
            c.record_call(coll, payload)
        c.save_tuning(cache)
    comm_mod.comm_destroy_all()
    tl = faults.HealthTimeline(faults.validate_schedule(
        faults.parse_fault_schedule("spine:spine2@step10=0.25"),
        profiles=[cluster.nic_tier, tier], n_nodes=2))
    comm = comm_mod.FlexCommunicator("pod", 2, comm_mod.CommConfig(
        profile=tier.name, tuning_cache=cache, fault=tl.spec()))
    clock = faults.FabricClock(tl, comms=lambda: [comm])
    committed = []
    for step in range(30):
        committed += clock.advance(step)
        comm.record_call(coll, payload)
    sc = comm.slot(coll, comm_mod.bucket_for(payload))
    return {"rekeys": clock.rekeys, "committed": committed,
            "profile": comm._effective_profile, "origin": sc.origin,
            "warm": sc.warm, "iterations": sc.tuned.iterations,
            "want": degraded.pod_tier.name,
            "signature": _torch_ranks.plain_signature(comm.plan_signature()),
            "report": json.dumps(clock.report(), sort_keys=True,
                                 default=str)}


def test_spine_fault_rekeys_pod_comm_as_reference(tmp_path):
    from repro import faults as j_faults
    from repro_torch import faults as t_faults
    t = _spine_fault(t_comm, t_topo, t_faults, TColl.ALL_REDUCE,
                     str(tmp_path / "t.json"))
    j = _spine_fault(j_comm, j_topo, j_faults, JColl.ALL_REDUCE,
                     str(tmp_path / "j.json"))
    assert plain(t) == plain(j)
    assert t["rekeys"] == 1 and len(t["committed"]) == 1
    assert t["committed"][0]["step"] == 10 + t_faults.HYSTERESIS_K - 1
    assert t["profile"] == t["want"]
    assert t["warm"] and t["iterations"] == 0
    assert t["origin"] == "transition:exact"


def test_resolve_faults_validates_spine_targets_as_reference():
    """test_pod.py:456-466 in both packages, with equal timelines."""
    specs = []
    for mod, topo in ((t_clusters, t_topo), (j_clusters, j_topo)):
        _, _, tl = mod.resolve_faults(_pod_cluster(topo, 2, 2), 2, "h800",
                                      fault="spine:spine2@step10=0.25",
                                      pods=2)
        assert tl is not None
        specs.append(tl.spec())
        with pytest.raises(ValueError, match="spine2"):
            mod.resolve_faults(topo.make_cluster("h800", 2), 2, "h800",
                               fault="spine:spine2@step10=0.25")
    assert specs[0] == specs[1]


def test_ctx_refuses_a_cluster_of_other_pods():
    """tests/test_pod.py's ctx contract (reference tp.py:123-127) in both
    packages: a three-tier cluster whose pods differ from the pod axis is
    refused before any communicator."""
    from repro.models.tp import ParallelCtx as JCtx
    from repro_torch.models.tp import ParallelCtx as TCtx
    for ctx_cls, topo, cfg in ((JCtx, j_topo, j_comm.CommConfig),
                               (TCtx, t_topo, t_comm.CommConfig)):
        with pytest.raises(ValueError, match="pods but the mesh's pod axis"):
            ctx_cls(dp_axis="data", dp_size=2, node_axis="node",
                    node_size=2, pod_axis="pod", pod_size=4,
                    cluster=topo.cluster_for("h100", 2, pods=2),
                    comm_config=cfg(profile="h100", tag="pods-mismatch"))


def test_expert_specs_follow_the_rebuilt_ep_span():
    """After an elastic node loss the loop re-targets the expert dim of
    its param specs to the rebuilt mesh's ep span (``respec_ep``): the
    (node, data) specs of Kimi-K2 become the (data) ones, the model-axis
    entries untouched."""
    from repro_torch.configs import get_config
    from repro_torch.convert import respec_ep
    from repro_torch.models.transformer import param_specs
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    for old in (("node", "data"), EP_AXES, "data"):
        assert respec_ep(param_specs(cfg, data_axis=old), "data") == \
            param_specs(cfg, data_axis="data")
    assert respec_ep(param_specs(cfg, data_axis="data"), EP_AXES) == \
        param_specs(cfg, data_axis=EP_AXES)
