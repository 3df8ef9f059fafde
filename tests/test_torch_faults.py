"""The port's fault tier against the JAX reference (DESIGN.md §14,
tests/test_faults.py).

In this process, with ``==``: the copied ``FabricClock`` and the port's
``FlexCommunicator.apply_health_state`` against the reference's, driven
by the same schedule and ``record_call`` sequence on the NIC tier of
``make_cluster("h800", 2, nics_per_node=4, nic_gbit=400.0)`` — the
reference test's flapping rail, projection, short burst, warm re-key
(``transition:exact``, zero Stage-1 iterations, equal tuning-cache
JSON), carried shares (``transition:carry``), restore, and measured
mode's event recorder across a transition.  Reports, transition records,
plan signatures, shares, member weights and origins must be equal.

Elastic resume (on gloo ranks, rank side ``_torch_ranks.elastic``, which
imports no JAX): the reference's own elastic test fails in XLA (ROADMAP
queue 3), so the port is held to that test's contract against itself —
reduced glm4-9b on (node=2, data=2, model=2), 11 steps, a snapshot every
3, ``node1@step5=down`` and then ``node0@step5=down``: the commit lands at
step 8, the survivors resume from snapshot 6, and every param leaf equals
a fresh (data=2, model=2) launch that restores snapshot 6, bit for bit.
A third run, ``node1@step3=down``, commits at step 6 itself, right after
rank 0's save of snapshot 6: every survivor must resume from that one.
The survivors' post-drop losses are also held against the reference's
(data=2, model=2) train step (built undonated, as tests/test_torch_cluster.py
builds it) restored from the same snapshot 6, within 5e-3.

The launchers: ``--fault`` through the train launcher on 4 gloo ranks
(the reference's report assertions, and the transition the reference's
clock commits for the same timeline), no ``"faults"`` block without it,
node events refused as the reference refuses them; a clock on a serving
engine advances once a tick and leaves the streams alone.
"""

import dataclasses
import enum
import json
import types

import numpy as np
import pytest
import torch

import _torch_ranks
from repro.cluster import topology as j_topo
from repro.configs import clusters as j_clusters
from repro.control import SimEventRecorder as JEventRecorder
from repro.core import communicator as j_comm
from repro.core.topology import Collective as JColl
from repro import faults as j_faults
from repro_torch.cluster import topology as t_topo
from repro_torch.configs import clusters as t_clusters
from repro_torch.control import SimEventRecorder as TEventRecorder
from repro_torch.core import communicator as t_comm
from repro_torch.core.topology import Collective as TColl
from repro_torch import faults as t_faults
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import run_ranks

MiB = 1 << 20
PAYLOAD = 16 * MiB
K = t_faults.HYSTERESIS_K

J = types.SimpleNamespace(topo=j_topo, comm=j_comm, faults=j_faults,
                          AR=JColl.ALL_REDUCE, Recorder=JEventRecorder)
T = types.SimpleNamespace(topo=t_topo, comm=t_comm, faults=t_faults,
                          AR=TColl.ALL_REDUCE, Recorder=TEventRecorder)

#: the elastic cases: the reference test's schedule, steps and shapes
#: (node0 last: its run's rank 0 leaves the process for good; node1's
#: third run commits at step 6, a multiple of the snapshot period, as the
#: surviving writer's save of step 6 lands)
ELASTIC = {"steps": 11, "seq_len": 16, "batch": 8, "resume": 6,
           "ckpt_every": 3,
           "drops": {"node1": "node1@step5=down",
                     "node1-at-save": "node1@step3=down",
                     "node0": "node0@step5=down"}}


def _commit(schedule: str) -> int:
    """The step a ``node<i>@step<N>=down`` loss commits at: N + K - 1."""
    return int(schedule.split("@step")[1].split("=")[0]) + K - 1


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


def _cluster(pkg, name):
    return pkg.topo.make_cluster("h800", 2, nics_per_node=4,
                                 nic_gbit=400.0, name=name)


def _timeline(pkg, schedule, tier, n_nodes=2):
    f = pkg.faults
    return f.HealthTimeline(f.validate_schedule(
        f.parse_fault_schedule(schedule), profiles=[tier], n_nodes=n_nodes))


def _comm(pkg, tier, tl=None, **kw):
    return pkg.comm.FlexCommunicator("node", 2, pkg.comm.CommConfig(
        profile=tier.name, fault=tl.spec() if tl else "", **kw))


def _both(drive, *args):
    """``drive(pkg, *args)`` on the reference and on the port."""
    return drive(J, *args), drive(T, *args)


# ---------------------------------------------------------------------------
# the clock and the communicator, port against reference
# ---------------------------------------------------------------------------

def _flap(pkg):
    tier = _cluster(pkg, "flt_flap").nic_tier
    flap = ",".join(f"rail3@step{i}={0.25 if i % 2 else 1.0}"
                    for i in range(1, 61))     # ends on a restore
    tl = _timeline(pkg, flap, tier)
    comm = _comm(pkg, tier, tl)
    comm.record_call(pkg.AR, PAYLOAD)
    sig = plain(comm.plan_signature())
    clock = pkg.faults.FabricClock(tl, comms=lambda: [comm])
    advanced = []
    for step in range(70):
        advanced += clock.advance(step)
        comm.record_call(pkg.AR, PAYLOAD)
    return {"advanced": advanced, "report": clock.report(),
            "sig_before": sig, "sig": plain(comm.plan_signature()),
            "profile": comm._effective_profile, "tier": tier.name}


def test_flapping_rail_zero_rekeys_as_reference():
    want, got = _both(_flap)
    assert got == want
    assert got["advanced"] == [] and got["report"]["rekeys"] == 0
    assert got["report"]["suppressed_flaps"] > 0
    assert got["report"]["transitions"] == []
    assert got["sig"] == got["sig_before"]
    assert got["profile"] == got["tier"]


def test_projection_rows_as_reference():
    def rows(pkg):
        tier = _cluster(pkg, "flt_proj").nic_tier
        tl = _timeline(pkg, "rail3@step10=0.25,node1@step20=down", tier)
        return pkg.faults.FabricClock(tl).projection()
    want, got = _both(rows)
    assert got == want
    assert [r["kind"] for r in got] == ["degrade", "node"]
    assert all(r["commit_step"] == r["step"] + K - 1 for r in got)


def test_burst_shorter_than_hysteresis_suppressed_as_reference():
    def burst(pkg):
        tier = _cluster(pkg, "flt_burst").nic_tier
        tl = _timeline(pkg, f"rail3@step10=0.25,rail3@step{10 + K - 1}=1.0",
                       tier)
        comm = _comm(pkg, tier, tl)
        comm.record_call(pkg.AR, PAYLOAD)
        clock = pkg.faults.FabricClock(tl, comms=lambda: [comm])
        advanced = [clock.advance(step) for step in range(30)]
        return advanced, clock.report(), plain(comm.plan_signature())
    want, got = _both(burst)
    assert got == want
    assert all(a == [] for a in got[0])
    assert got[1]["rekeys"] == 0 and got[1]["suppressed_flaps"] == 1


def _warm(pkg, tmp_path):
    cluster = _cluster(pkg, "flt_warm")
    tier = cluster.nic_tier
    degraded = pkg.topo.degrade_cluster(cluster, "rail:rail3=0.25")
    cache = str(tmp_path / f"tuning-{pkg.comm.__name__}.json")
    # seed the cache: one cold tune per fabric state
    for prof in (degraded.nic_tier.name, tier.name):
        c = pkg.comm.FlexCommunicator("node", 2, pkg.comm.CommConfig(
            profile=prof, tuning_cache=cache))
        for _ in range(12):
            c.record_call(pkg.AR, PAYLOAD)
        c.save_tuning(cache)
    with open(cache) as f:
        seeded = json.load(f)
    tl = _timeline(pkg, "rail3@step10=0.25", tier)
    comm = _comm(pkg, tier, tl, tuning_cache=cache)
    clock = pkg.faults.FabricClock(tl, comms=lambda: [comm])
    committed = []
    for step in range(40):
        committed += clock.advance(step)
        comm.record_call(pkg.AR, PAYLOAD)
    sc = comm.slot(pkg.AR, pkg.comm.bucket_for(PAYLOAD))
    after = str(tmp_path / f"after-{pkg.comm.__name__}.json")
    comm.save_tuning(after)
    with open(after) as f:
        saved = json.load(f)
    return {"committed": committed, "report": clock.report(),
            "profile": comm._effective_profile,
            "degraded": degraded.nic_tier.name,
            "slot": (sc.warm, sc.tuned.iterations, sc.origin,
                     plain(sc.shares), plain(sc.member_weights())),
            "sig": plain(comm.plan_signature()),
            "seeded": seeded, "saved": saved}


def test_persistent_fault_rekeys_once_warm_as_reference(tmp_path):
    want, got = _warm(J, tmp_path), _warm(T, tmp_path)
    assert got == want
    assert got["report"]["rekeys"] == 1 and len(got["committed"]) == 1
    tr = got["committed"][0]
    assert tr["kind"] == "degrade" and tr["step"] == 10 + K - 1
    assert got["profile"] == got["degraded"]
    warm, iters, origin = got["slot"][:3]
    assert warm and iters == 0 and origin == "transition:exact"
    info = tr["rekeyed"]["node"]["slots"][
        f"all_reduce@{t_comm.bucket_for(PAYLOAD)}"]
    assert info == {"origin": "transition:exact", "warm": True,
                    "stage1_iters": 0}
    assert got["report"]["state"]["degrades"] == ["rail:rail3=0.25"]


def _carry(pkg, schedule):
    tier = _cluster(pkg, "flt_carry").nic_tier
    tl = _timeline(pkg, schedule, tier)
    comm = _comm(pkg, tier, tl)
    clock = pkg.faults.FabricClock(tl, comms=lambda: [comm])
    for _ in range(4):
        comm.record_call(pkg.AR, PAYLOAD)
    bucket = pkg.comm.bucket_for(PAYLOAD)
    before = dict(comm.slot(pkg.AR, bucket).shares)
    for step in range(40):
        clock.advance(step)
        comm.record_call(pkg.AR, PAYLOAD)
    sc = comm.slot(pkg.AR, bucket)
    return {"before": before, "shares": dict(sc.shares),
            "weights": sc.member_weights(), "origin": sc.origin,
            "report": clock.report(), "profile": comm._effective_profile,
            "tier": tier.name, "sig": plain(comm.plan_signature())}


def test_transition_without_cache_carries_live_shares_as_reference():
    want, got = _both(_carry, "rail3@step5=0.25")
    assert got == want
    assert got["origin"] == "transition:carry"
    assert got["shares"] == got["before"]
    w = got["weights"]["rail"]
    assert w["rail3"] < min(w["rail0"], w["rail1"], w["rail2"])


def test_restore_transition_returns_to_base_profile_as_reference():
    want, got = _both(_carry, "rail3@step5=0.25,rail3@step20=1.0")
    assert got == want
    assert got["report"]["rekeys"] == 2
    assert got["profile"] == got["tier"]
    assert len(set(got["weights"]["rail"].values())) == 1


def test_event_recorder_reattaches_across_a_transition_as_reference():
    def events(pkg):
        tier = _cluster(pkg, "flt_events").nic_tier
        comm = pkg.comm.FlexCommunicator("node", 2, pkg.comm.CommConfig(
            profile=tier.name, timing="measured", tag="flt_events"))
        rec = pkg.Recorder(comm.model)
        attached = comm.attach_recorder_events(rec)
        if pkg is J:
            import jax.numpy as jnp
            x = jnp.zeros((1024, 1024), jnp.float32)
        else:
            x = torch.zeros((1024, 1024), dtype=torch.float32)
        comm.plan_for(pkg.AR, x)
        issued = bool(comm.issued_calls())
        for _ in range(8):
            comm.observe_executed_step(elapsed_s=0.01)
        ts = comm.timing
        while hasattr(ts, "inner"):
            ts = ts.inner
        out = {"attached": attached, "issued": issued,
               "updates": ts.event_updates,
               "steps": rec.steps_recorded,
               "has_events": bool(ts.report()["event_recorder"])}
        out["info"] = comm.apply_health_state(("rail:rail3=0.25",))
        before = rec.steps_recorded
        comm.plan_for(pkg.AR, x)
        comm.observe_executed_step(elapsed_s=0.01)
        out["more"] = rec.steps_recorded - before
        out["follows"] = rec.model is comm.model
        out["timing"] = type(comm.timing).__name__
        out["shares"] = plain({k: sc.shares for k, sc in
                               comm._slots.items()})
        return out
    want, got = _both(events)
    assert got == want
    assert got["attached"] and got["issued"] and got["has_events"]
    assert got["updates"] > 0 and got["steps"] > 0
    assert got["info"] is not None and got["more"] > 0 and got["follows"]


# ---------------------------------------------------------------------------
# elastic node loss, on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The 8-rank runs (node1 dropped, node1 dropped as the snapshot
    lands, then node0), then the fresh 4-rank launch from node1's
    snapshot 6, spawned once each."""
    root = tmp_path_factory.mktemp("elastic")
    case = dict(ELASTIC, ckpt={n: str(root / n) for n in ELASTIC["drops"]})
    runs = run_ranks(_torch_ranks.elastic, 8, device="cpu", timeout_s=600,
                     args=(case,))
    fresh = run_ranks(_torch_ranks.elastic, 4, device="cpu", timeout_s=300,
                      args=(dict(case, fresh_from=case["ckpt"]["node1"]),))
    return case, runs, [f["fresh"] for f in fresh]


@pytest.mark.parametrize("drop", sorted(ELASTIC["drops"]))
def test_elastic_node_drop_resumes_bit_identical(elastic, drop):
    """The reference test's contract: the node loss commits at 5 + K - 1
    = 8 (at 3 + K - 1 = 6 in the third run, so no step is replayed), the
    survivors resume from snapshot 6 on the flat (data=2,
    model=2) mesh over their own ranks, the clock re-attaches to the
    rebuilt ctx, the history holds the replayed steps, and every param
    leaf equals the fresh post-drop launch's, bit for bit.  The lost
    node's ranks leave at the commit (node 0's too: rank 0 exits and the
    survivors go on)."""
    case, runs, fresh = elastic
    steps, resume = case["steps"], case["resume"]
    commit = _commit(case["drops"][drop])
    node = int(drop[len("node")])
    lost = [r for r in range(8) if r // 4 == node]
    survivors = [r for r in range(8) if r // 4 != node]
    by_rank = [r[drop] for r in runs]
    for r in lost:
        got = by_rank[r]
        assert got["dropped_at"] == commit
        assert len(got["history"]) == commit
        assert not got["reattached"]
    assert [f["meta_step"] for f in fresh] == [resume] * 4
    for i, r in enumerate(survivors):
        got = by_rank[r]
        assert got["dropped_at"] is None
        assert [t for t in got["transitions"] if t["kind"] == "node"] == [
            {"kind": "node", "node": node, "step": commit}]
        assert any(f"from checkpoint step {resume}" in m
                   for m in got["logs"]), got["logs"]
        assert got["reattached"]
        assert got["mesh"] == (tuple(survivors), i, ("data", "model"), 1)
        assert len(got["history"]) == commit + steps - resume
        assert len(got["history"]) > steps or commit == resume
        # the lost node's ranks ran the same steps before the commit
        assert by_rank[lost[0]]["history"] == got["history"][:commit]
        assert got["history"][commit:] == fresh[i]["history"]
        assert got["params"] == fresh[i]["params"], f"rank {r}"


def test_elastic_runs_snapshot_the_same_bits(elastic):
    """Every drop trained the same steps before snapshot 6: the runs'
    snapshot 6 files are equal, so one fresh launch holds them all."""
    case, _, _ = elastic
    files = [np.load(f"{case['ckpt'][n]}/ckpt_{case['resume']:08d}.npz")
             for n in sorted(case["drops"])]
    for other in files[1:]:
        assert sorted(files[0].files) == sorted(other.files)
        for k in files[0].files:
            if k != "__meta__":
                np.testing.assert_array_equal(files[0][k], other[k])


@pytest.fixture(scope="module")
def ref_resume(elastic):
    """The reference's (data=2, model=2) train step, jitted without
    donation (its donated multi-axis steps fail in XLA, ROADMAP queue 3),
    restored from node1's snapshot 6 by the reference's Checkpointer and
    run to the end on the same batches: its per-step losses."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch import steps as JS
    from repro.launch.mesh import make_mesh
    from repro.models import init_params
    from repro.models.transformer import param_specs
    from repro.optim.adamw import AdamWConfig, init_state
    from repro.train.train_step import make_train_step
    case, _, _ = elastic
    cfg = get_config("glm4-9b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    ctx = JS.make_ctx(mesh, j_comm.CommConfig(profile="h800",
                                              tag="ref-resume"))
    psp = param_specs(cfg, data_axis="data")
    osp = JS.opt_state_specs(psp)
    step = jax.jit(shard_map(
        make_train_step(cfg, ctx, AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=case["steps"]),
            remat=True),
        mesh=mesh, in_specs=(psp, osp, JS._batch_specs(cfg, SH.InputShape(
            "t", "train", case["seq_len"], case["batch"]), mesh)),
        out_specs=(psp, osp, P()), check_vma=False))
    tmpl = init_params(jax.random.PRNGKey(0), cfg)
    params, opt_state, meta = JCheckpointer(case["ckpt"]["node1"]).restore(
        tmpl, init_state(tmpl), case["resume"])
    assert meta["step"] == case["resume"]
    batches = make_batches(cfg, seq_len=case["seq_len"],
                           batch_per_shard=case["batch"])
    losses = []
    with mesh:
        for _ in range(case["resume"], case["steps"]):
            params, opt_state, m = step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("drop", sorted(ELASTIC["drops"]))
def test_elastic_resume_losses_match_reference(elastic, ref_resume, drop):
    """Every survivor's losses after the resume are finite and within
    5e-3 (tests/test_cluster.py:350's bound) of the reference's step run
    from the same snapshot: a fault shared by restore_templates,
    Checkpointer.restore and build_train_program, which the fresh launch
    shares too, would show here."""
    case, runs, _ = elastic
    commit = _commit(case["drops"][drop])
    node = int(drop[len("node")])
    for r in range(8):
        if r // 4 == node:
            continue
        got = runs[r][drop]["history"][commit:]
        assert len(got) == len(ref_resume) == case["steps"] - case["resume"]
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, ref_resume, atol=5e-3,
                                   err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_train_launcher_fault_schedule_report(tmp_path):
    """The reference test's report assertions, on 4 gloo ranks at
    (node=2, data=2): one transition at 3 + K - 1, the NIC tier re-keyed,
    the state degraded, the program re-keyed; and the transition equals
    the one the reference's clock commits for the same timeline over
    reference communicators with the run's tuned slots."""
    out = str(tmp_path / "run.json")
    rc = t_train.main(["--smoke", "--device", "cpu", "--dist", "gloo",
                       "--steps", "12", "--seq-len", "16",
                       "--mesh-shape", "2,1", "--nodes", "2",
                       "--fault", "rail3@step3=0.25", "--out", out])
    assert rc == 0
    with open(out) as f:
        rep = json.load(f)
    fr = rep["faults"]
    assert fr["hysteresis_k"] == K
    assert len(fr["transitions"]) == 1
    assert fr["transitions"][0]["step"] == 3 + K - 1
    assert fr["rekeys"] >= 1
    assert fr["state"]["degrades"] == ["rail:rail3=0.25"]
    assert rep["program"]["plan_rekeys"] >= 1
    assert "schedule" in fr and fr["schedule"]
    assert sorted(fr["transitions"][0]["rekeyed"]) == ["node"]

    cluster, profile, tl = j_clusters.resolve_faults(
        None, 2, "h100", fault="rail3@step3=0.25")
    assert t_clusters.resolve_faults(
        None, 2, "h100", fault="rail3@step3=0.25")[2].spec() == tl.spec()
    comms = {
        "data": j_comm.FlexCommunicator("data", 2, j_comm.CommConfig(
            profile=profile, fault=tl.spec())),
        "node": j_comm.FlexCommunicator("node", 2, j_comm.CommConfig(
            profile=cluster.nic_tier.name, fault=tl.spec()),
            ortho_name="data")}
    clock = j_faults.FabricClock(tl, comms=lambda: list(comms.values()))
    for step in range(12):
        clock.advance(step)
        if step == 0:
            for axis, slots in rep["tuning"].items():
                for key in slots:
                    op, bucket = key.split("@")
                    comms[axis].slot(JColl(op), int(bucket))
    want = json.loads(json.dumps(clock.report()))
    assert fr["transitions"] == want["transitions"]
    assert fr["state"] == want["state"] and fr["rekeys"] == want["rekeys"]


def test_fault_free_launch_reports_no_faults(tmp_path):
    out = str(tmp_path / "run.json")
    rc = t_train.main(["--smoke", "--device", "cpu", "--steps", "4",
                       "--seq-len", "16", "--out", out])
    assert rc == 0
    with open(out) as f:
        rep = json.load(f)
    assert "faults" not in rep


def test_node_events_are_refused_as_the_reference(capsys):
    """The train launcher needs --ckpt-dir for a node event (exit 2 with
    the reference's ValueError text, before any rank is spawned); the
    serve launcher refuses node events with the reference's message."""
    rc = t_train.main(["--smoke", "--device", "cpu", "--dist", "gloo",
                       "--nodes", "2", "--mesh-shape", "2,1",
                       "--fault", "node1@step3=down"])
    assert rc == 2
    assert ("elastic node loss needs --ckpt-dir: resume is only defined "
            "from a Checkpointer snapshot") in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs --ckpt-dir"):
        j_faults.make_train_resume(None, opt=None, shape=None,
                                   comm_config=None, cluster=None, dp=1,
                                   tp=1, ckpt_dir="", batches_fn=None)
    with pytest.raises(ValueError, match="needs --ckpt-dir"):
        t_faults.make_train_resume(None, opt=None, comm_config=None,
                                   mesh=None, cluster=None, ckpt_dir="",
                                   batches_fn=None)
    with pytest.raises(SystemExit, match="--fault node events need the "
                       "training loop's elastic resume; serving supports "
                       "link/member schedules only"):
        t_serve.main(["--smoke", "--device", "cpu", "--nodes", "2",
                      "--fault", "node1@step2=down"])


@pytest.mark.parametrize("engine", ["wave", "paged"])
def test_serving_engine_ticks_the_clock(engine):
    """A clock on the ctx advances once a tick (the reference's engines
    do the same), its report equal to the reference's clock's over as
    many ticks; a one-device ctx has no communicator, so its transitions
    re-key nothing, and the streams equal a fault-free run's."""
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as TE
    cfg = get_config("glm4-9b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, profile, tl = t_clusters.resolve_faults(
        None, 1, "h100", fault="nvlink@step2=0.5,nvlink@step6=1.0")
    prompts = [list(range(3, 3 + n)) for n in (5, 3, 9, 4)]

    def serve(fault):
        ctx = ParallelCtx(comm_config=CommConfig(
            profile=profile, fault=tl.spec() if fault else ""))
        clock = t_faults.FabricClock(tl).attach(ctx) if fault else None
        if engine == "wave":
            eng = TE.ServeEngine(params, cfg, ctx,
                                 TE.ServeConfig(slots=2, cache_len=32))
        else:
            eng = TE.PagedServeEngine(params, cfg, ctx, TE.PagedServeConfig(
                max_requests=2, cache_len=32, kv_block=8,
                max_tokens_in_flight=8, min_bucket=4))
        for p in prompts:
            eng.submit(p, max_new=6)
        eng.run_until_drained()
        fin, ticks = eng.finished(), eng._ticks
        eng.close()
        return fin, ticks, clock

    fin, ticks, clock = serve(True)
    base, base_ticks, _ = serve(False)
    assert fin == base and ticks == base_ticks > 6 + K
    assert clock.step == ticks - 1
    ref = j_faults.FabricClock(j_clusters.resolve_faults(
        None, 1, "h100", fault="nvlink@step2=0.5,nvlink@step6=1.0")[2])
    for tick in range(ticks):
        ref.advance(tick)
    rep = clock.report()
    assert rep == ref.report()
    assert [t["step"] for t in rep["transitions"]] == [2 + K - 1, 6 + K - 1]
    assert rep["rekeys"] == 0 and all(t["rekeyed"] == {}
                                      for t in rep["transitions"])
