"""The port's two-tier cluster against the JAX reference (DESIGN.md §9,
tests/test_cluster.py, tests/test_members.py, tests/test_overlap.py).

In this process, with ``==`` on everything returned: the copies
``repro_torch.cluster.{topology,simulator}``, ``configs.clusters`` and
``faults.schedule`` against the reference's (named presets, synthesized
tiers, degrades, node drops, the cluster timing model's times and
crossovers, ``resolve_cluster`` / ``resolve_faults``), a member drain on
a NIC-tier communicator re-keying its plan signature, and the ctx's
profile-mismatch refusal.

On gloo ranks, spawned twice for the module (8 ranks, then 4; rank side
``_torch_ranks.cluster``, which imports no JAX), against the reference
under ``shard_map`` on the conftest's 8 CPU devices, from the same
small-integer payloads (every partial sum exact, so any summation order
gives the same bits):

* the hierarchical all-reduce, all-gather and reduce-scatter of a
  ClusterCommunicator at (node, data) = (2, 4), (4, 2), (2, 2), each tier
  pinned to multi-route shares (the NIC tier's ortho detour over data),
  bit for bit, with equal plan signatures; the N=1 (1, 4) cluster equals
  the bare communicator's bits and signature;
* the ctx on (node=2, data=2, model=2): comms order, the hierarchical
  gradient reduce, plan signature, tiers and the ``"cluster"`` report
  block; on (node=4) the inter tier alone;
* the fused metrics reduce over the (node, data) plane against the nested
  sums, and test_overlap.py's ``cluster`` parity corners (bucketed ==
  monolithic == the reference's bucketed sync);
* reduced glm4-9b trained 4 steps on (node=2, data=2, model=2) against
  the reference's cluster step (built without donation, as
  tests/test_torch_moe.py's ``ep_reference``: the donated one fails in
  XLA) and against the port's flat (data=4, model=2) run, within 5e-3,
  the reference's own bound.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import _torch_ranks
from repro.cluster import simulator as j_csim
from repro.cluster import topology as j_topo
from repro.compat import shard_map
from repro.configs import clusters as j_clusters
from repro.core import communicator as j_comm
from repro.core import links as j_links
from repro.core.topology import Collective as JColl
from repro_torch.cluster import simulator as t_csim
from repro_torch.cluster import topology as t_topo
from repro_torch.configs import clusters as t_clusters
from repro_torch.core import communicator as t_comm
from repro_torch.core import links as t_links
from repro_torch.core.topology import Collective as TColl
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.tp import ParallelCtx

INTRA = "h800"
#: pinned shares: the intra tier has no ortho axis on a (node, data) mesh,
#: so its pin is primary + staged; the NIC tier's ortho detours over data
INTRA_SHARES = {"nvlink": 60, "pcie": 40, "rdma": 0}
NIC_SHARES = {"rail": 50, "xrail": 25, "host_tcp": 25}
OPS = ("all_reduce", "all_gather", "reduce_scatter")
LAYOUTS = {8: [(2, 4), (4, 2)], 4: [(2, 2), (1, 4)]}
DTYPES = ("float32", "bfloat16", "int32")
PARITY = [("float32", False), ("bfloat16", True), ("float32", True),
          ("bfloat16", False)]
CTX = {8: {"ctx-grad": (2, 2, 2)}, 4: {"ctx-inter-only": (4, 1, 1)}}
TRAIN = {"cluster": ((2, 2, 2), ("node", "data", "model")),
         "flat": ((4, 2), ("data", "model"))}
STEPS = 4
PRESETS = sorted(j_clusters.CLUSTER_IDS)
BASES = ("h800", "h100", "a800", "gb200", "tpu_v5e")


def plain(obj):
    """Framework-neutral form for ``==`` (tests/test_torch_core_copy.py):
    dataclasses and enums of either package become tuples and values."""
    import enum
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


def _coll_name(layout, dtype):
    return f"{layout[0]}x{layout[1]}-{dtype}"


def _coll_cases(world):
    cases = {}
    for k, layout in enumerate(LAYOUTS[world]):
        for j, dt in enumerate(DTYPES):
            if layout[0] == 1 and dt != "float32":
                continue
            ops = OPS if dt != "int32" else ("all_reduce",)
            cases[_coll_name(layout, dt)] = {
                "layout": layout, "dtype": dt, "ops": ops,
                "profile": INTRA,
                # rows split over every rank; the all-reduce payload's
                # per-rank length (15) pads to the intra tier's multiple
                "x": _ints((world * 8, 5), 10 * k + j),
                "x_ar": _ints((world * 5, 3), 10 * k + j + 100)}
    return cases


def _parity_cases():
    def grads(ep):
        rng = np.random.default_rng(7)
        g = {"deep": {"w": rng.integers(0, 8, size=(8 * 24, 8))},
             "mid": rng.integers(0, 8, size=(8 * 4, 3)),
             "tail": rng.integers(0, 8, size=(8, 2))}
        if ep:
            g["moe"] = {"experts": {"wi": rng.integers(0, 8,
                                                       size=(8 * 8, 5))}}
        return jax.tree.map(lambda a: a.astype(np.float32), g)
    return {f"{dt}-ep{int(ep)}": {"grads": grads(ep), "dtype": dt, "ep": ep,
                                  "bucket_mb": 256 / 2.0 ** 20}
            for dt, ep in PARITY}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster")
    cache = str(d / "pinned.json")
    nic = t_topo.make_cluster(INTRA, 2).nic_tier.name
    for n in (2, 4):
        _torch_ranks.pinned_profile(cache, INTRA, n, INTRA_SHARES, ops=OPS)
        _torch_ranks.pinned_profile(cache, nic, n, NIC_SHARES, ops=OPS)
    return {"cache": cache}


@pytest.fixture(scope="module")
def init_np():
    from repro.configs import get_config
    from repro.models import init_params
    return jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), get_config("glm4-9b").reduced()))


def _case(world, work, init_np):
    case = {"cache": work["cache"], "coll": _coll_cases(world),
            "ctx": {name: {"shape": shape, "profile": "tpu_v5e",
                           "x": _ints((8 * 16, 3), 3)}
                    for name, shape in CTX[world].items()}}
    if world == 8:
        case["metrics"] = {"x": (np.arange(8 * 6, dtype=np.float32)
                                 % 7).reshape(8 * 6, 1)}
        case["parity"] = _parity_cases()
        case["params"] = init_np
        case["train"] = {name: {"shape": shape, "axes": axes,
                                "steps": STEPS}
                         for name, (shape, axes) in TRAIN.items()}
    return case


@pytest.fixture(scope="module")
def port(work, init_np):
    out = {}
    for world in (8, 4):
        out[world] = run_ranks(_torch_ranks.cluster, world, backend="gloo",
                               device="cpu", timeout_s=600,
                               args=(_case(world, work, init_np),))
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _ref_cluster_comm(layout, cache, tag):
    from repro.cluster.communicator import ClusterCommunicator
    n, m = layout
    topo = j_topo.make_cluster(INTRA, n)
    intra = (j_comm.FlexCommunicator("data", m, j_comm.CommConfig(
        profile=INTRA, tuning_cache=cache, tag=f"{tag}-intra"))
        if m > 1 else None)
    inter = (j_comm.FlexCommunicator("node", n, j_comm.CommConfig(
        profile=topo.nic_tier.name, tuning_cache=cache,
        tag=f"{tag}-inter"), "data" if m > 1 else None) if n > 1 else None)
    return ClusterCommunicator(topo, intra, inter)


@pytest.fixture(scope="module")
def reference(work):
    """Each collective case's global outputs and plan signatures, from
    ONE shard_map of the reference's ClusterCommunicator per case."""
    out = {}
    spec = P(("node", "data"))
    for world in (8, 4):
        for name, c in _coll_cases(world).items():
            j_comm.comm_destroy_all()
            cc = _ref_cluster_comm(c["layout"], work["cache"], name)

            def run(x, xa, cc=cc, ops=c["ops"]):
                got = {"all_reduce": cc.all_reduce(xa)}
                if "all_gather" in ops:
                    got["all_gather"] = cc.all_gather(x, tiled=True)
                    got["reduce_scatter"] = cc.reduce_scatter(x)
                return got

            out_specs = {op: (P() if op == "all_gather" else spec)
                         for op in c["ops"]}
            f = jax.jit(shard_map(run, mesh=_jmesh(c["layout"],
                                                   ("node", "data")),
                                  in_specs=(spec, spec), out_specs=out_specs,
                                  check_vma=False))
            dt = jnp.dtype(c["dtype"])
            got = f(jnp.asarray(c["x"]).astype(dt),
                    jnp.asarray(c["x_ar"]).astype(dt))
            out[name] = {op: np.asarray(v.astype(jnp.float32)
                                        if dt != jnp.int32 else v)
                         for op, v in got.items()}
            out[name]["signature"] = tuple(
                (a, _torch_ranks.plain_signature(s))
                for a, s in cc.plan_signature())
    j_comm.comm_destroy_all()
    return out


def _exact(layout, dtype, op, x, x_ar):
    """The exact result for rank r of the flat (node, data) reduction or
    gather, from the host: the ``i * n + node`` reduce-scatter order."""
    n, m = layout
    world = n * m
    if op == "all_reduce":
        s = sum(np.split(x_ar, world))
        return [s] * world
    if op == "all_gather":
        return [x] * world
    s = sum(np.split(x, world))
    seg = np.split(s, world)
    return [seg[(r % m) * n + r // m] for r in range(world)]


#: (world, collective case, op): int32 through the all-reduce only, as
#: tests/test_cluster.py:177; the N=1 layout in float32, as :112
COLL = [(w, name, op) for w in (8, 4) for name, c in _coll_cases(w).items()
        for op in c["ops"]]


@pytest.mark.parametrize("world,name,op", COLL)
def test_hierarchical_collectives_bit_exact_vs_reference(
        port, reference, world, name, op):
    case = _coll_cases(world)[name]
    layout, dtype = case["layout"], case["dtype"]
    want = reference[name][op]
    exact = _exact(layout, dtype, op, case["x"], case["x_ar"])
    for r, got in enumerate(port[world]):
        g = got["coll"][name][op]
        w = want if op == "all_gather" else np.split(want, world)[r]
        np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
        np.testing.assert_array_equal(g, exact[r], err_msg=f"rank {r}")


@pytest.mark.parametrize("world,k", [(8, 0), (8, 1), (4, 0), (4, 1)])
def test_cluster_plan_signatures_equal_reference(port, reference, world, k):
    layout = LAYOUTS[world][k]
    for dt in DTYPES:
        name = _coll_name(layout, dt)
        if name not in reference:
            continue
        for r, got in enumerate(port[world]):
            assert got["coll"][name]["signature"] == \
                reference[name]["signature"], f"{name} rank {r}"
            assert got["coll"][name]["hierarchical"] == (layout[0] > 1)
    sig = dict(reference[_coll_name(layout, "float32")]["signature"])
    if layout[0] > 1:
        # every route of the pinned NIC tier runs, and two intra ones
        for axis, routes in (("node", {"primary", "staged", "ortho"}),
                             ("data", {"primary", "staged"})):
            for *_, p in sig[axis]:
                units = dict(dict(p)["chunk_units"])
                assert {r for r, u in units.items() if u} == routes, p


def test_n1_cluster_is_the_bare_communicator(port):
    """An N=1 cluster resolves the same plans and runs bit-identically to
    the bare intra communicator (tests/test_cluster.py:112)."""
    name = _coll_name((1, 4), "float32")
    for got in port[4]:
        c = got["coll"][name]
        assert not c["hierarchical"]
        assert c["signature"] == (("data", c["flat_signature"]),)
        for op in OPS:
            np.testing.assert_array_equal(c[op], c["flat"][op])


# ---------------------------------------------------------------------------
# the ctx on a node mesh
# ---------------------------------------------------------------------------

def _ref_ctx(name, shape):
    from repro.models.tp import ParallelCtx as JCtx
    sizes = dict(zip(("node", "data", "model"), shape))
    return JCtx(tp_axis="model" if sizes["model"] > 1 else None,
                dp_axis="data" if sizes["data"] > 1 else None,
                node_axis="node", tp_size=sizes["model"],
                dp_size=sizes["data"], node_size=sizes["node"],
                comm_config=j_comm.CommConfig(profile="tpu_v5e", tag=name))


@pytest.fixture(scope="module")
def ref_ctx():
    out = {}
    for world, cases in CTX.items():
        for name, shape in cases.items():
            j_comm.comm_destroy_all()
            ctx = _ref_ctx(name, shape)
            x = _ints((8 * 16, 3), 3)
            spec = P(("node", "data"))
            f = jax.jit(shard_map(lambda v: ctx.grad_all_reduce({"w": v})["w"],
                                  mesh=_jmesh(shape, ("node", "data",
                                                      "model")),
                                  in_specs=(spec,), out_specs=spec,
                                  check_vma=False))
            y = np.asarray(f(jnp.asarray(x)))
            rep = ctx.comm_report()
            out[name] = {
                "y": y, "axes": [c.axis_name for c in ctx.comms()],
                "signature": tuple((a, _torch_ranks.plain_signature(s))
                                   for a, s in ctx.plan_signature()),
                "tiers": {a: rep[a]["tier"] for a in rep if a != "cluster"},
                "cluster": json.dumps(rep["cluster"], sort_keys=True,
                                      default=str),
                "hierarchical": ctx._cluster_comm.hierarchical,
                "ep": (ctx.ep_axes, ctx.ep_size, ctx.ep_spec_axis())}
    j_comm.comm_destroy_all()
    return out


@pytest.mark.parametrize("world,name", [(8, "ctx-grad"),
                                        (4, "ctx-inter-only")])
@pytest.mark.parametrize("what", ["y", "axes", "signature", "tiers",
                                  "cluster", "hierarchical", "ep"])
def test_ctx_node_axis_matches_reference(port, ref_ctx, world, name, what):
    want = ref_ctx[name]
    shape = CTX[world][name]
    shards = shape[0] * shape[1]
    for r, got in enumerate(port[world]):
        g = got["ctx"][name][what]
        if what == "y":
            i = r // shape[2]
            np.testing.assert_array_equal(
                g, np.split(want["y"], shards)[i], err_msg=f"rank {r}")
        elif what == "ep":
            assert (tuple(g[0]), g[1], g[2]) == want["ep"]
        else:
            assert g == want[what], f"rank {r}"


def test_ctx_on_a_cluster_mesh_reports_the_tiers(port):
    got = port[8][0]["ctx"]["ctx-grad"]
    assert got["axes"] == ["model", "data", "node"]
    assert [s[0] for s in got["signature"]] == ["model", "data", "node"]
    assert got["tiers"] == {"model": "intra", "data": "intra",
                            "node": "inter"}
    roll = json.loads(got["cluster"])["rollup"]
    assert set(roll) == {"intra", "inter"} and roll["inter"]["slots"] >= 1
    inter_only = port[4][0]["ctx"]["ctx-inter-only"]
    assert inter_only["axes"] == ["node"] and not inter_only["hierarchical"]


def test_ctx_rejects_cluster_profile_mismatch():
    """tests/test_cluster.py:394 in both packages: a cluster of other
    nodes than the comm profile is refused before any communicator."""
    from repro.models.tp import ParallelCtx as JCtx
    for ctx_cls, topo, cfg in (
            (JCtx, j_topo.make_cluster("h800", 2), j_comm.CommConfig),
            (ParallelCtx, t_topo.make_cluster("h800", 2),
             t_comm.CommConfig)):
        with pytest.raises(ValueError, match="fabric that never ran"):
            ctx_cls(dp_axis="data", dp_size=2, node_axis="node",
                    node_size=2, cluster=topo,
                    comm_config=cfg(profile="tpu_v5e", tag="mismatch"))
    with pytest.raises(ValueError, match="nodes but the mesh"):
        ParallelCtx(node_axis="node", node_size=4,
                    cluster=t_topo.make_cluster("h100", 2))


def test_metrics_reduce_matches_nested_sums(port):
    """tests/test_overlap.py:315: the fused reduce over the (node, data)
    plane equals the nested node / data sums bit for bit, and the exact
    sum; means divide by the plane's 8 ranks."""
    x = (np.arange(8 * 6, dtype=np.float32) % 7).reshape(8 * 6, 1)
    for got in port[8]:
        m = got["metrics"]
        np.testing.assert_array_equal(m["loss"], m["nested"])
        assert float(m["loss"]) == float(x.sum())
        assert float(m["lr"]) == pytest.approx(0.5)


@pytest.fixture(scope="module")
def ref_parity():
    """The reference's bucketed sync of each cluster parity corner
    (tests/test_overlap.py:_parity_ctx's cluster layout)."""
    from types import SimpleNamespace
    from repro.models.tp import ParallelCtx as JCtx
    from repro.train.train_step import sync_grads as j_sync
    out = {}
    for name, c in _parity_cases().items():
        j_comm.comm_destroy_all()
        ctx = JCtx(dp_axis="data", node_axis="node", dp_size=4, node_size=2,
                   comm_config=j_comm.CommConfig(profile="tpu_v5e",
                                                 tag="ov-node"))
        cfg = SimpleNamespace(moe=SimpleNamespace(impl="ep_a2a")
                              if c["ep"] else None)
        grads = jax.tree.map(lambda a: jnp.asarray(a).astype(c["dtype"]),
                             c["grads"])
        spec = P(("node", "data"))
        f = shard_map(lambda t: ctx.await_all(j_sync(
            t, cfg, ctx, bucket_mb=c["bucket_mb"])),
            mesh=_jmesh((2, 4), ("node", "data")), in_specs=(spec,),
            out_specs=spec, check_vma=False)
        out[name] = _torch_ranks.flat_leaves(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jax.jit(f)(grads)))
    j_comm.comm_destroy_all()
    return out


@pytest.mark.parametrize("dtype,ep", PARITY)
def test_bucketed_sync_cluster_parity(port, ref_parity, dtype, ep):
    """test_overlap.py's ``cluster`` corners: bucketed == monolithic bit
    for bit on every rank, and == the reference's bucketed sync."""
    name = f"{dtype}-ep{int(ep)}"
    want = ref_parity[name]
    for r, got in enumerate(port[8]):
        mono, buck = got["parity"][name]["mono"], got["parity"][name]["buck"]
        assert mono.keys() == buck.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(buck[k], mono[k], err_msg=k)
            rows = want[k].shape[0] // 8
            np.testing.assert_array_equal(
                buck[k], want[k][r * rows:(r + 1) * rows], err_msg=k)


# ---------------------------------------------------------------------------
# training on (node=2, data=2, model=2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_train(init_np):
    """The reference's cluster train step, undonated, 4 steps."""
    from repro.configs import get_config
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch import steps as JS
    from repro.launch.mesh import make_mesh
    from repro.models.transformer import param_specs
    from repro.optim.adamw import AdamWConfig, init_state
    from repro.train.train_step import make_train_step
    j_comm.comm_destroy_all()
    cfg = get_config("glm4-9b").reduced()
    mesh = make_mesh((2, 2, 2), ("node", "data", "model"))
    ctx = JS.make_ctx(mesh, j_comm.CommConfig(profile="tpu_v5e",
                                              tag="e2e-cluster"))
    assert ctx._cluster_comm is not None
    psp = param_specs(cfg, data_axis=ctx.ep_spec_axis() or "data")
    step = jax.jit(shard_map(
        make_train_step(cfg, ctx, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=20), remat=True),
        mesh=mesh, in_specs=(psp, JS.opt_state_specs(psp),
                             JS._batch_specs(cfg, SH.InputShape(
                                 "t", "train", 32, 4), mesh)),
        out_specs=(psp, JS.opt_state_specs(psp), P()), check_vma=False))
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
    return losses


def test_multi_node_train_matches_reference_and_flat(port, ref_train):
    """Every rank's cluster losses are equal, finite, within 5e-3 of the
    reference's cluster step (tests/test_cluster.py:350's bound) and of
    the port's flat (data=4, model=2) run, whose ranks agree too."""
    runs = {name: [got["train"][name] for got in port[8]]
            for name in TRAIN}
    for name, per_rank in runs.items():
        assert all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
    cluster = runs["cluster"][0]
    assert cluster["node_size"] == 2 and cluster["cluster"]
    assert not runs["flat"][0]["cluster"]
    assert all(np.isfinite(cluster["losses"]))
    np.testing.assert_allclose(cluster["losses"], ref_train, atol=5e-3)
    np.testing.assert_allclose(cluster["losses"],
                               runs["flat"][0]["losses"], atol=5e-3)
    assert cluster["losses"][-1] < cluster["losses"][0]


# ---------------------------------------------------------------------------
# the copies, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
def test_named_presets_equal_reference(name):
    t, j = t_clusters.get_cluster(name), j_clusters.get_cluster(name)
    assert plain(t) == plain(j)
    assert t.describe() == j.describe()
    assert t_links.PROFILES[t.nic_tier.name] is t.nic_tier
    assert t.tiers == j.tiers and t.rail_rings() == j.rail_rings()


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_cluster_for_equals_reference(base, n):
    t, j = t_topo.cluster_for(base, n), j_topo.cluster_for(base, n)
    assert plain(t) == plain(j)
    assert t.nic_tier.name == j_topo.nic_tier_name(
        base, j.nics_per_node, j.nic_gbit)
    assert t.flatten() is t_links.PROFILES[base]
    # the tier profile is registered once, whatever the node count
    assert t_topo.cluster_for(base, 2 * n).nic_tier is t.nic_tier


def test_cluster_for_and_named_presets_agree():
    """tests/test_cluster.py:335 on the port."""
    assert t_topo.cluster_for("tpu_v5e", 2).nic_tier is \
        t_clusters.get_cluster("2xtpu_v5e_dcn").nic_tier
    assert "2xh800_rail4" in t_clusters.CLUSTER_IDS
    with pytest.raises(KeyError):
        t_clusters.get_cluster("nonexistent")
    assert t_clusters.CLUSTER_IDS == j_clusters.CLUSTER_IDS


@pytest.mark.parametrize("kw", [
    dict(nics_per_node=4, nic_gbit=400.0),
    dict(nics_per_node=8, nic_gbit=400.0, rail_aligned=False),
    dict(nics_per_node=2, nic_gbit=200.0)])
def test_tier_synthesis_equals_reference(kw):
    assert plain(t_topo.make_nic_tier(t_links.PROFILES["h100"], **kw)) == \
        plain(j_topo.make_nic_tier(j_links.PROFILES["h100"], **kw))
    assert t_topo.nic_tier_name("h100", kw["nics_per_node"], kw["nic_gbit"],
                                kw.get("rail_aligned", True)) == \
        j_topo.nic_tier_name("h100", kw["nics_per_node"], kw["nic_gbit"],
                             kw.get("rail_aligned", True))
    assert plain(t_topo.make_pod_tier(t_links.PROFILES["h800"],
                                      pod_uplinks=kw["nics_per_node"])) == \
        plain(j_topo.make_pod_tier(j_links.PROFILES["h800"],
                                   pod_uplinks=kw["nics_per_node"]))


def test_register_profile_rejects_conflicting_name():
    topo = t_topo.make_cluster("h800", 2)
    clash = dataclasses.replace(topo.nic_tier, inter_hop_us=99.0)
    with pytest.raises(ValueError):
        t_links.register_profile(clash)
    a = t_topo.make_nic_tier(t_links.PROFILES["h800"], nics_per_node=8)
    b = t_topo.make_nic_tier(t_links.PROFILES["h800"], nics_per_node=8)
    assert t_links.register_profile(a) is t_links.register_profile(b)


@pytest.mark.parametrize("spec", ["rail3=0.25", "rail:rail3=0.25",
                                  "pcie=0.5", "nvlink=0.5", "xrail=0.5",
                                  "host_tcp=0.1"])
def test_degrade_cluster_equals_reference(spec):
    """tests/test_members.py:467: the fault lands on the owning tier, with
    the reference's deterministic names."""
    t = t_topo.degrade_cluster(t_topo.make_cluster("h800", 2,
                                                   nics_per_node=8), spec)
    j = j_topo.degrade_cluster(j_topo.make_cluster("h800", 2,
                                                   nics_per_node=8), spec)
    assert plain(t) == plain(j)


def test_degrade_and_drop_node_refusals_equal_reference():
    for mod in (t_topo, j_topo):
        cl = mod.make_cluster("h800", 2)
        with pytest.raises(KeyError):
            mod.degrade_cluster(cl, "nosuch=0.5")
        with pytest.raises(ValueError):
            mod.degrade_cluster(cl, "rail3")
        with pytest.raises(ValueError):
            mod.drop_node(cl, 2)
        with pytest.raises(ValueError):
            mod.drop_node(mod.make_cluster("h800", 1), 0)
    assert plain(t_topo.drop_node(t_topo.make_cluster("h100", 4), 1)) == \
        plain(j_topo.drop_node(j_topo.make_cluster("h100", 4), 1))


SIM_CASES = [("h800", 2, 8), ("h800", 4, 8), ("h800", 1, 8), ("h800", 4, 1),
             ("h100", 2, 4), ("tpu_v5e", 2, 4)]


@pytest.mark.parametrize("base,n,m", SIM_CASES)
def test_cluster_timing_model_equals_reference(base, n, m):
    """tests/test_cluster.py:84-108's pricing in both packages: tier,
    hierarchical and flat times, bandwidths and crossovers are equal."""
    tm = t_csim.ClusterTimingModel(t_topo.make_cluster(base, n), m)
    jm = j_csim.ClusterTimingModel(j_topo.make_cluster(base, n), m)
    for op in ("all_reduce", "all_gather", "reduce_scatter"):
        to, jo = TColl(op), JColl(op)
        for b in (64 * 1024, 1 << 24, 256 << 20):
            assert tm.hierarchical_time(to, b) == jm.hierarchical_time(jo, b)
            assert tm.hierarchical_time(to, b, flex=False) == \
                jm.hierarchical_time(jo, b, flex=False)
            assert tm.flat_time(to, b) == jm.flat_time(jo, b)
            assert tm.algbw_GBps(to, b) == jm.algbw_GBps(jo, b)
            assert tm.tier_time("inter", to, n, b) == \
                jm.tier_time("inter", jo, n, b)
        assert tm.crossover_bytes(to) == jm.crossover_bytes(jo)
    for sched in ("rail_local", "naive", "flat"):
        assert tm.a2a_time(1 << 22, schedule=sched) == \
            jm.a2a_time(1 << 22, schedule=sched)
    assert tm.a2a_crossover_bytes() == jm.a2a_crossover_bytes()
    assert t_csim.PHASE_SYNC_US == j_csim.PHASE_SYNC_US


def test_hierarchy_beats_flat_ring_for_large_messages():
    """tests/test_cluster.py:84 on the port."""
    model = t_csim.ClusterTimingModel(t_topo.make_cluster("h800", 2), 8)
    big, small = 256 << 20, 64 * 1024
    for op in (TColl.ALL_REDUCE, TColl.ALL_GATHER):
        assert model.hierarchical_time(op, big) < model.flat_time(op, big)
    assert model.flat_time(TColl.ALL_REDUCE, small) < \
        model.hierarchical_time(TColl.ALL_REDUCE, small)
    xo = model.crossover_bytes(TColl.ALL_REDUCE)
    assert xo is not None and small < xo <= big


RESOLVE = [("", 0, ""), ("", 2, ""), ("2xh800_rail4", 0, ""),
           ("4xh800_rail4", 4, "rail3=0.25"), ("", 2, "nvlink=0.5"),
           ("", 0, "nvlink=0.5"), ("2xh800_rail4", 1, "pcie=0.5"),
           ("", 2, "rail:rail1=0.5,pcie=0.5")]


@pytest.mark.parametrize("name,nodes,degrade", RESOLVE)
def test_resolve_cluster_and_faults_equal_reference(name, nodes, degrade):
    """The launchers' ``--cluster --nodes --degrade`` resolution."""
    got = []
    for mod in (t_clusters, j_clusters):
        cluster, n, pods = mod.resolve_cluster(name, nodes)
        profile = cluster.node.name if cluster else "h100"
        cluster, profile, timeline = mod.resolve_faults(
            cluster, n, profile, degrade=degrade)
        assert timeline is None
        got.append((plain(cluster), n, pods, profile))
    assert got[0] == got[1]


@pytest.mark.parametrize("spec", ["nvlink@step2=0.5", "node1@step3=down",
                                  "nosuch=0.5"])
def test_degrade_refuses_what_the_reference_refuses(spec):
    for mod in (t_clusters, j_clusters):
        with pytest.raises((ValueError, KeyError)):
            mod.resolve_faults(None, 2, "h100", degrade=spec)


@pytest.mark.parametrize("spec", ["rail3@step200=0.25,node1@step400=down",
                                  "rail:rail3@step200=0.25,pcie@step100=down",
                                  "rail3@step600=1.0,rail3=0.25"])
def test_fault_schedule_copy_equals_reference(spec):
    """The copied DSL parses, validates against a cluster's tiers and
    folds into active states as the reference's."""
    from repro.faults import schedule as j_sched
    from repro_torch.faults import schedule as t_sched
    got = []
    for sched, topo in ((t_sched, t_topo), (j_sched, j_topo)):
        cl = topo.make_cluster("h800", 2)
        events = sched.parse_fault_schedule(spec)
        canon = sched.validate_schedule(
            events, profiles=[cl.nic_tier, cl.node], n_nodes=2)
        tl = sched.HealthTimeline(canon)
        got.append(([plain(e) for e in events], [plain(e) for e in canon],
                    [plain(tl.state_at(s)) for s in (0, 150, 300, 700)],
                    tl.spec()))
    assert got[0] == got[1]


def _drain(comm_mod, links_mod, topo_mod, MEMBER_BASE):
    cl = topo_mod.make_cluster("h800", 2, nics_per_node=8, nic_gbit=400.0,
                               name="members_h800_rail8_d")
    degraded = topo_mod.degrade_cluster(cl, "rail3=0.25").nic_tier
    links_mod.register_profile(degraded)
    coll = (TColl if comm_mod is t_comm else JColl).ALL_REDUCE
    comm = comm_mod.FlexCommunicator(
        "node", 2, comm_mod.CommConfig(profile=degraded.name))
    sc = comm.slot(coll, 256 << 20)
    for bal in sc.member_balancers.values():
        for k in bal.shares:
            bal.shares[k] = MEMBER_BASE
    sigs = [_torch_ranks.plain_signature(comm.plan_signature())]
    moved = 0
    for _ in range(400):
        moved += bool(comm.observe_executed_step())
        comm._default_recorder.record(coll, 256 << 20)
    sigs.append(_torch_ranks.plain_signature(comm.plan_signature()))
    return (sigs, moved, comm.plan_cache.stats.retraces,
            sc.member_weights()["rail"],
            json.dumps(comm.report(), sort_keys=True, default=str))


def test_member_drain_rekeys_nic_tier_signature_as_reference():
    """tests/test_members.py:204 in both packages: one rail at 0.25 drains
    through Stage 2, the NIC tier's plan signature re-keys once, and
    everything the two communicators return is equal."""
    from repro.control import MEMBER_BASE as J_BASE
    from repro_torch.control import MEMBER_BASE as T_BASE
    t = _drain(t_comm, t_links, t_topo, T_BASE)
    j = _drain(j_comm, j_links, j_topo, J_BASE)
    assert t == j
    sigs, moved, retraces, weights, _ = t
    assert moved and sigs[0] != sigs[1] and 1 <= retraces <= 2
    assert weights["rail3"] < min(v for k, v in weights.items()
                                  if k != "rail3")


def test_cluster_communicator_refusals():
    from repro.cluster.communicator import ClusterCommunicator as JCC
    from repro_torch.cluster.communicator import ClusterCommunicator as TCC
    for cls, topo_mod, comm_mod in ((TCC, t_topo, t_comm),
                                    (JCC, j_topo, j_comm)):
        topo = topo_mod.make_cluster("h800", 2)
        with pytest.raises(ValueError, match="at least one live tier"):
            cls(topo, None, None)
        inter = comm_mod.FlexCommunicator(
            "node", 4, comm_mod.CommConfig(profile=topo.nic_tier.name))
        with pytest.raises(ValueError, match="inter tier spans 4"):
            cls(topo, None, inter)


LAUNCH = {
    # the acceptance run: 8 gloo ranks, the NIC tier degraded at launch
    "nodes": ["--nodes", "2", "--mesh-shape", "2,2", "--degrade",
              "rail3=0.25"],
    # a named cluster implies its nodes and profile; bucketed sync, and a
    # checkpoint written by node 0's data row 0 only
    "cluster": ["--cluster", "2xh800_rail4", "--mesh-shape", "1,2",
                "--bucket-mb", "0.5"],
}


def test_train_launcher_runs_a_cluster(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --dist gloo`` with
    ``--nodes/--degrade`` and ``--cluster``: every rank's losses agree (the
    launcher checks), the loss falls, the report carries the cluster
    block of the reference's topology, and one checkpoint file lands."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = {}
    for name, flags in LAUNCH.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--device", "cpu", "--dist", "gloo", "--steps", "6",
             "--out", str(tmp_path / f"{name}.json"),
             "--ckpt-dir", str(tmp_path / f"ckpt-{name}"), *flags],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    outs = {name: p.communicate(timeout=300) for name, p in procs.items()}
    want = {"nodes": j_topo.degrade_cluster(
                j_topo.cluster_for("h100", 2), "rail3=0.25"),
            "cluster": j_clusters.get_cluster("2xh800_rail4")}
    for name, (out, err) in outs.items():
        assert procs[name].returncode == 0, err[-3000:]
        rep = json.loads((tmp_path / f"{name}.json").read_text())
        assert rep["ranks"] == {"nodes": 8, "cluster": 4}[name]
        assert rep["losses"][-1] < rep["losses"][0]
        assert rep["cluster"]["topology"] == want[name].describe()
        assert set(rep["cluster"]["rollup"]) >= {"inter"}
        assert len(os.listdir(tmp_path / f"ckpt-{name}")) == 1
