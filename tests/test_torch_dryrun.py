"""The port's dry-run (``launch/dryrun.py``), ``StepProgram.lower``, the
dry mesh and ``forward(remat="dots")``, against the reference.

The reference's dry-run module forces 512 host devices at import, so it
runs only in subprocesses (``tests/_torch_dryrun_ref.py``: its
``run_one`` record and the per-call list ``parse_collectives`` gave it),
started once for the module in the background; the port's CLI runs
(``python -m repro_torch.launch.dryrun``) follow one another in two
more background threads, and the port's in-process work runs here meanwhile.
Every test waits only for what it reads.

Where the port's record differs from the reference's, the difference is
asserted as recorded, with its cause:

* the output bytes: XLA's ``memory_analysis`` counts the output tuple's
  index table, 8 bytes a leaf, which a tree of meta tensors has not;
* train_4k on (2, 4): the traced structure (``TRAIN_STRUCTURE_DIFF``).
  XLA's collective_permutes are the port's ``batch_isend_irecv`` ring
  steps, one a tensor, and the counts differ where XLA's HLO and the
  port's trace convention (layer 0 records, the checkpoint recompute
  does not) part: the reference's layer body holds its
  rematerialized combines beside the forward and backward ones, the
  port's traced log has none (the recompute runs under
  ``ctx.unrecorded()``), and XLA attributes 9 ortho-route permutes
  (model-axis neighbours one data row over) to no axis (``@unknown``).
"""

import collections
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import communicator as t_comm
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (Mesh, make_production_mesh, mesh_dims,
                                     mesh_nodes, run_ranks)

import _torch_ranks

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

#: the reference's runs: name -> its dry-run flags
REF_RUNS = {
    "decode": ["--arch", "glm4-9b", "--shape", "decode_32k",
               "--mesh", "single", "--tuning-cache", "{work}/ref.json"],
    "train": ["--arch", "glm4-9b", "--shape", "train_4k",
              "--mesh-split", "2,4"],
}
#: the port's CLI runs with no reference counterpart: name -> flags (the
#: reference's own two cluster dry-runs fail; ROADMAP queue 3)
CLI_RUNS = {
    "cluster-glm4-fault": ["--arch", "glm4-9b", "--shape", "train_4k",
                           "--nodes", "2", "--mesh-split", "2,2",
                           "--fault", "rail3@step200=0.25"],
    "cluster-mixtral": ["--arch", "mixtral-8x7b", "--shape", "train_4k",
                        "--nodes", "2", "--mesh-split", "2,2"],
    "pods": ["--arch", "glm4-9b", "--shape", "train_4k", "--pods", "2",
             "--nodes", "2"],
    "prefill": ["--arch", "whisper-medium", "--shape", "prefill_32k"],
    "compress": ["--arch", "glm4-9b", "--shape", "train_4k",
                 "--mesh-split", "2,2", "--compress", "secondary=fp8"],
}
#: train_4k on (2, 4): op@axis -> (reference's HLO count, port's traced
#: count), where they differ (module docstring)
TRAIN_STRUCTURE_DIFF = {"all_reduce@model": (19, 17),
                        "collective_permute@model": (345, 306),
                        "collective_permute@data": (158, 156),
                        "collective_permute@unknown": (9, 0)}
#: the roofline's keys that need no hardware constant
HW_FREE = ("flops_fwd", "flops_total", "hbm_bytes", "collective_bytes_total",
           "collective_by_axis", "collective_by_op", "n_buckets",
           "model_flops", "useful_flops_ratio", "params", "active_params")


class _Background:
    """Subprocesses started now, in a thread, one after another; each
    result is (returncode, stdout, stderr, record or None)."""

    def __init__(self, runs, work):
        self.results = {}
        self._done = {name: threading.Event() for name in runs}
        self._thread = threading.Thread(target=self._run,
                                        args=(runs, work), daemon=True)
        self._thread.start()

    def _run(self, runs, work):
        for name, (argv, out) in runs.items():
            env = dict(os.environ, PYTHONPATH=SRC)
            env.pop("XLA_FLAGS", None)
            try:
                proc = subprocess.run(argv, env=env, cwd=work,
                                      capture_output=True, text=True,
                                      timeout=600)
                rec = None
                if proc.returncode == 0 and os.path.exists(out):
                    with open(out) as f:
                        rec = json.load(f)
                self.results[name] = (proc.returncode, proc.stdout,
                                      proc.stderr, rec)
            except Exception as e:     # noqa: BLE001 - read by the test
                self.results[name] = (-1, "", repr(e), None)
            self._done[name].set()

    def get(self, name):
        assert self._done[name].wait(900), f"{name} did not finish"
        rc, out, err, rec = self.results[name]
        assert rc == 0, f"{name}: rc {rc}\n{out[-3000:]}\n{err[-3000:]}"
        return rec, out

    def join(self):
        self._thread.join(timeout=900)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dryrun")


@pytest.fixture(scope="module", autouse=True)
def ref(work):
    """The reference's two dry-runs, each in its own thread (they start
    with the module, before anything of the port)."""
    helper = os.path.join(ROOT, "tests", "_torch_dryrun_ref.py")
    runs = {}
    for name, flags in REF_RUNS.items():
        out = str(work / f"ref-{name}.json")
        runs[name] = {name: ([sys.executable, helper, out, "--",
                              *(f.format(work=work) for f in flags)], out)}
    bgs = {name: _Background(r, str(work)) for name, r in runs.items()}

    class Ref:
        def get(self, name):
            return bgs[name].get(name)[0]
    yield Ref()
    for bg in bgs.values():
        bg.join()


@pytest.fixture(scope="module", autouse=True)
def cli(work, ref):
    """The port's CLI runs, one after another in each of two background
    threads."""
    runs = {}
    for name, flags in CLI_RUNS.items():
        out = work / f"cli-{name}"
        tag = D.result_tag(_args(flags), *_pair(flags))
        runs[name] = ([sys.executable, "-m", "repro_torch.launch.dryrun",
                       *flags, "--out", str(out)],
                      str(out / f"{tag}.json"))
    names = list(runs)
    bgs = [_Background({n: runs[n] for n in names[i::2]}, str(work))
           for i in range(2)]

    class Cli:
        def get(self, name):
            return bgs[names.index(name) % 2].get(name)
    yield Cli()
    for bg in bgs:
        bg.join()


def _args(flags):
    """The parsed flags of one CLI run, for its result tag."""
    import argparse
    ap = argparse.ArgumentParser()
    for f in ("--arch", "--shape", "--fault", "--compress", "--cluster",
              "--degrade", "--mesh-split"):
        ap.add_argument(f, default="")
    for f in ("--nodes", "--pods"):
        ap.add_argument(f, type=int, default=0)
    ap.add_argument("--bucket-mb", type=float, default=0.0)
    ap.add_argument("--backend", default="flexlink")
    return ap.parse_args(flags)


def _pair(flags):
    a = _args(flags)
    split = (tuple(int(x) for x in a.mesh_split.split(","))
             if a.mesh_split else None)
    return a.arch, a.shape, "single", a.nodes, a.pods, split


@pytest.fixture(autouse=True)
def _fresh_comms():
    t_comm.comm_destroy_all()
    yield
    t_comm.comm_destroy_all()


# ---------------------------------------------------------------------------
# the dry mesh
# ---------------------------------------------------------------------------

def test_production_meshes_and_dims():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.shape, single.axes, single.world) == (
        (16, 16), ("data", "model"), 256)
    assert (multi.shape, multi.axes, multi.world) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert single.wire == multi.wire == "dry"
    assert single.device.type == "meta"
    assert mesh_dims(single) == (1, 16, 16) and mesh_dims(multi) == (2, 16,
                                                                     16)
    cl = Mesh.dry((2, 2, 4, 2), ("pod", "node", "data", "model"), rank=13)
    assert mesh_dims(cl) == (2, 4, 2) and mesh_nodes(cl) == 2
    assert mesh_nodes(single) == 1


def test_eval_shapes_and_opt_state_specs():
    """The dry-run's meta trees: params of the reference's global shapes,
    float32 moments, an int32 step; the moments shard as the params
    (``opt_state_specs``), the step is replicated."""
    from repro.configs import get_config as j_get
    from repro.launch.steps import eval_shape_params as j_eval
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.launch.steps import (eval_shape_opt_state,
                                          eval_shape_params, opt_state_specs)
    from repro_torch.models.transformer import param_specs
    cfg = get_config("glm4-9b")
    params = eval_shape_params(cfg)
    leaves = torch.utils._pytree.tree_leaves(params)
    want = jax.tree.leaves(j_eval(j_get("glm4-9b")))
    # (JAX flattens dict keys sorted, torch in insertion order)
    assert sorted(tuple(t.shape) for t in leaves) == sorted(
        tuple(w.shape) for w in want)
    assert all(t.device.type == "meta" for t in leaves)
    opt = eval_shape_opt_state(params)
    assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    specs = opt_state_specs(param_specs(cfg))
    assert specs.step == () and specs.mu is specs.nu
    mu = shard_params(opt.mu, specs.mu, 3, 16)
    local = shard_params(params, param_specs(cfg), 3, 16)
    assert [(t.shape, t.dtype) for t in torch.utils._pytree.tree_leaves(
        mu)] == [(t.shape, torch.float32)
                 for t in torch.utils._pytree.tree_leaves(local)]


def test_dry_mesh_has_the_live_layout():
    """Coords, lines, peers and plane of rank r as a live mesh computes
    them: row-major ranks, each line along an axis."""
    shape, axes = (2, 2, 4, 2), ("pod", "node", "data", "model")
    grid = np.arange(32).reshape(shape)
    for r in (0, 13, 31):
        m = Mesh.dry(shape, axes, rank=r)
        c = np.unravel_index(r, shape)
        assert m.coords == tuple(int(x) for x in c) and m.rank == r
        for i, a in enumerate(axes):
            idx = list(c)
            idx[i] = slice(None)
            line = tuple(int(x) for x in grid[tuple(idx)])
            assert m._line[a] == line
            assert m.peer(a, 1) == line[1] and m.axis_index(a) == c[i]
        assert m.plane == ("pod", "node", "data")
    with pytest.raises(ValueError):
        Mesh.dry((2, 2), ("data", "model"), rank=4)


def test_dry_mesh_logs_and_answers_meta():
    m = Mesh.dry((2, 4), ("data", "model"))
    x = torch.empty((8, 3), dtype=torch.bfloat16, device="meta")
    assert m.all_reduce(x, "model").shape == (8, 3)
    assert m.all_gather(x, "model").shape == (4, 8, 3)
    assert m.reduce_scatter(x, "model").shape == (2, 3)
    assert m.all_to_all(x, "data").shape == (8, 3)
    assert m.broadcast(x, "data", 1).shape == (8, 3)
    with m.tracing() as log:
        with m.untraced():
            outs = m.permute([x, x.float()], "model", 1, 3)
        y = m.psum(x, "data")
    assert [o.dtype for o in outs] == [torch.bfloat16, torch.float32]
    assert all(o.device.type == "meta" for o in outs + [y])
    assert log.executed == [("collective_permute", "model", "bfloat16", 48),
                            ("collective_permute", "model", "float32", 96),
                            ("all_reduce", "data", "bfloat16", 48)]
    assert log.traced == log.executed[2:]
    # the mesh's own log has held every call since it was made
    assert m.log.structure() == {"all_reduce@model": 1, "all_gather@model": 1,
                                 "reduce_scatter@model": 1,
                                 "all_to_all@data": 1, "broadcast@data": 1,
                                 "all_reduce@data": 1}
    assert m.log.structure("executed")["collective_permute@model"] == 2
    assert m.log.bytes_by("executed")["collective_permute@model"] == 144


def test_dry_mesh_refuses_other_tensors():
    m = Mesh.dry((2, 1), ("data", "model"))
    for call in (lambda t: m.all_reduce(t, "data"),
                 lambda t: m.all_reduce(t, "model"),   # size 1: no wire
                 lambda t: m.permute([t], "data", 1, 1)):
        with pytest.raises(ValueError, match="meta tensors only"):
            call(torch.zeros(4))
    assert m.log.executed == []


def test_tuple_axes_log_as_one_label():
    m = Mesh.dry((2, 2, 2), ("node", "data", "model"))
    x = torch.empty((4,), device="meta")
    m.all_reduce(x, ("node", "data"))
    assert m.log.traced == [("all_reduce", "node+data", "float32", 16)]


# ---------------------------------------------------------------------------
# glm4-9b decode_32k on the production mesh, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_decode(work):
    prof = str(work / "port.json")
    return D.run_one("glm4-9b", "decode_32k", False, tuning_cache=prof,
                     profile="tpu_v5e"), prof


def test_decode_structure_and_calls_equal_reference(ref, port_decode):
    rec, _ = port_decode
    want = ref.get("decode")
    assert rec["ok"] and rec["chips"] == 256
    assert rec["collective_structure"] == {"all_reduce@model": 6,
                                           "all_gather@model": 1}
    assert rec["collective_structure"] == \
        want["record"]["hlo_collective_structure"]
    got = collections.Counter((op, axis, float(n)) for op, axis, _, n
                              in rec["collective_calls"]["traced"])
    assert got == collections.Counter(tuple(c) for c in want["calls"])
    assert len(want["calls"]) == 7


def test_decode_tuning_and_cold_profile_equal_reference(ref, port_decode,
                                                        work):
    rec, prof = port_decode
    want = ref.get("decode")["record"]
    assert rec["tuning"] == want["tuning"]
    slots = rec["tuning"]["model"]
    assert sorted(slots) == ["all_gather@1048576", "all_reduce@1048576"]
    assert all(s["stage1_iters"] == 6 and not s["warm"]
               for s in slots.values())
    with open(prof, "rb") as f, open(work / "ref.json", "rb") as g:
        assert f.read() == g.read()


def test_decode_memory_equals_reference(ref, port_decode):
    """Argument bytes equal; the output's differ by XLA's output tuple
    table, 8 bytes for each of the step's 3 output leaves (logits, k,
    v)."""
    mem = port_decode[0]["memory_analysis"]
    want = ref.get("decode")["record"]["memory_analysis"]
    assert mem["argument_size_in_bytes"] == want["argument_size_in_bytes"] \
        == 2003968036
    assert want["output_size_in_bytes"] == 671240216
    assert want["output_size_in_bytes"] - mem["output_size_in_bytes"] == 8 * 3


def test_decode_collective_bytes_beside_the_analytic_model(port_decode):
    """The analytic inventory counts the layer body's combines once and
    models no decode merge: the traced all-reduce bytes on every rank
    exceed it by exactly the log-sum-exp merge's three reductions (max,
    denominator, accumulator) of one layer."""
    rec = port_decode[0]
    chips = rec["chips"]
    traced = [c for c in rec["collective_calls"]["traced"]
              if c[0] == "all_reduce"]
    merge = [n for _, _, dt, n in traced if dt == "float32"]
    assert len(merge) == 3
    total = sum(n for *_, n in traced)
    assert (total - sum(merge)) * chips == \
        rec["roofline"]["collective_by_op"]["all_reduce"]
    # executed: all 40 layers, 40 x the layer's bytes plus the embedding's
    ex = rec["collective_calls"]["executed_bytes"]["all_reduce@model"]
    layer = total - 65536
    assert ex == 40 * layer + 65536


def test_port_warm_start_cycle(work, capsys):
    """tests/test_dryrun_cli.py's cycle through the port's main: a cold
    run saves its TuningProfile, a warm run from it makes zero Stage-1
    iterations on every slot (--assert-warm) and the same structure."""
    prof = str(work / "cycle.json")
    base = ["--arch", "glm4-9b", "--shape", "decode_32k", "--mesh",
            "single", "--tuning-cache", prof]
    assert D.main(base + ["--out", str(work / "cold")]) == 0
    assert D.main(base + ["--out", str(work / "warm"),
                          "--assert-warm"]) == 0
    tag = "glm4-9b__decode_32k__single__flexlink.json"
    recs = [json.loads((work / d / tag).read_text()) for d in ("cold",
                                                               "warm")]
    cold, warm = ([s for ax in r["tuning"].values() for s in ax.values()]
                  for r in recs)
    assert cold and warm
    assert all(not s["warm"] and s["stage1_iters"] > 0 for s in cold)
    assert all(s["warm"] and s["stage1_iters"] == 0 for s in warm)
    assert recs[0]["collective_structure"] == recs[1]["collective_structure"]
    # a second warm run over the same --out skips every pair: vacuous
    assert D.main(base + ["--out", str(work / "warm"),
                          "--assert-warm"]) == 2
    assert "no tuned slots were checked" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# glm4-9b train_4k on (data=2, model=4), against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_train():
    return D.run_one("glm4-9b", "train_4k", False, mesh_split=(2, 4),
                     profile="tpu_v5e")


def test_train_roofline_equals_reference_float_for_float(ref, port_train):
    got, want = port_train["roofline"], ref.get("train")["record"]["roofline"]
    for k in HW_FREE:
        assert got[k] == want[k], k
    assert port_train["mesh"] == "single2x4" and port_train["chips"] == 8


def test_train_tuning_and_memory_equal_reference(ref, port_train):
    want = ref.get("train")["record"]
    assert port_train["tuning"] == want["tuning"]
    mem, wmem = port_train["memory_analysis"], want["memory_analysis"]
    assert mem["argument_size_in_bytes"] == wmem["argument_size_in_bytes"] \
        == 24135245828
    # the output tuple's table: params, AdamW (step, mu, nu), 3 metrics
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import eval_shape_params
    leaves = len(torch.utils._pytree.tree_leaves(
        eval_shape_params(get_config("glm4-9b"))))
    n_out = leaves + (1 + 2 * leaves) + 3
    assert wmem["output_size_in_bytes"] - mem["output_size_in_bytes"] == \
        8 * n_out


def test_train_structure_differs_as_recorded(ref, port_train):
    want = ref.get("train")["record"]["hlo_collective_structure"]
    got = port_train["collective_structure"]
    diff = {k: (want.get(k, 0), got.get(k, 0))
            for k in set(want) | set(got) if want.get(k, 0) != got.get(k, 0)}
    assert diff == TRAIN_STRUCTURE_DIFF
    # the same gradient all-reduces over data, and the same kinds
    assert got["all_reduce@data"] == want["all_reduce@data"] == 22


def test_train_calls_share_the_reference_payloads(ref, port_train):
    """Every payload size the port's traced calls move over an axis is
    one the reference's HLO moves over it too."""
    want = {(op, axis, n) for op, axis, n in ref.get("train")["calls"]}
    got = {(op, axis, float(n)) for op, axis, _, n
           in port_train["collective_calls"]["traced"]}
    assert got <= want


# ---------------------------------------------------------------------------
# StepProgram.lower and program_scope
# ---------------------------------------------------------------------------

def _dry_tp_ctx(**comm):
    from repro_torch.core.communicator import CommConfig
    from repro_torch.models.tp import ParallelCtx
    return ParallelCtx(tp_axis="model", tp_size=8,
                       comm_config=CommConfig(profile="h800", **comm),
                       mesh=Mesh.dry((8,), ("model",)))


def test_lower_does_not_pollute_replay_log():
    """tests/test_program.py:337-345 on a dry mesh: lowering runs the step
    under a scratch recorder, so a later call records its collective
    once, the default recorder stays empty, the scratch recorder is gone
    and nothing lands in the executable cache."""
    from repro_torch.runtime.program import StepProgram
    ctx = _dry_tp_ctx()
    built = []

    def builder():
        built.append(1)
        return lambda v: ctx.tp_all_reduce(v)

    prog = StepProgram(builder, ctx)
    x = torch.empty((512, 8), device="meta")
    lowered = prog.lower(x)
    assert len(built) == 1 and lowered.log.traced == [
        ("all_reduce", "model", "float32", 512 * 8 * 4)]
    assert lowered.argument_bytes == lowered.output_bytes == 512 * 8 * 4
    comm = ctx.comms()[0]
    assert comm.recorder(prog.name).issued_calls() == []
    assert comm.issued_calls() == []
    assert prog.cache.report()["size"] == 0
    prog.step(x)
    assert len(comm.recorder(prog.name).issued_calls()) == 1
    assert set(comm.report()["programs"]) == {prog.name}
    assert lowered.plan_signature == ctx.plan_signature(prog.name)


def test_program_scope_unregisters_on_exit():
    """tests/test_program.py:356-371, both packages' scopes: the program's
    recorder exists inside and is gone on exit."""
    from jax.sharding import Mesh as JMesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.core.communicator import CommConfig as JCommConfig
    from repro.core.communicator import comm_init_rank
    from repro.models.tp import ParallelCtx as JCtx
    from repro.runtime.program import program_scope as j_scope
    from repro_torch.runtime.program import program_scope as t_scope
    jctx = JCtx(tp_axis="x", tp_size=8,
                comm_config=JCommConfig(profile="h800"))
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(8), ("x",))

    def j_builder():
        return jax.jit(shard_map(lambda v: jctx.tp_all_reduce(v),
                                 mesh=jmesh, in_specs=(P("x"),),
                                 out_specs=P("x"), check_vma=False))

    with j_scope(j_builder, jctx) as prog:
        prog(jnp.zeros((8 * 64, 8), jnp.float32))
        jname = prog.name
        assert comm_init_rank("x", 8, JCommConfig(profile="h800")) \
            .recorder(jname) is not None
    with pytest.raises(KeyError):
        jctx.comms()[0].recorder(jname)

    tctx = _dry_tp_ctx()
    with t_scope(lambda: lambda v: tctx.tp_all_reduce(v), tctx) as prog:
        prog(torch.empty((64, 8), device="meta"))
        tname = prog.name
        assert tctx.comms()[0].recorder(tname) is not None
    with pytest.raises(KeyError):
        tctx.comms()[0].recorder(tname)


PINNED = {"nvlink": 50, "pcie": 25, "rdma": 25}
LOWER_CASES = {
    "train": {"kind": "train", "bucket_mb": 0.0},
    "train-b": {"kind": "train", "bucket_mb": 0.05},
    "serve": {"kind": "decode", "seq": 32, "batch": 4, "pos": 5},
}


@pytest.fixture(scope="module")
def lowered_live(work):
    """4 gloo ranks on (data=2, model=2), both axes' all-reduce slots
    pinned to three routes: each case lowered, then called live."""
    cache = str(work / "pinned.json")
    _torch_ranks.pinned_profile(cache, "h100", 2, PINNED)
    rng = np.random.default_rng(0)
    cases = {}
    for name, c in LOWER_CASES.items():
        c = dict(c)
        if c["kind"] == "train":
            c["batch"] = {k: rng.integers(0, 512, (4, 16)).astype(np.int32)
                          for k in ("tokens", "labels")}
        else:
            c["token"] = rng.integers(0, 512, (c["batch"], 1)).astype(
                np.int32)
        cases[name] = c
    return run_ranks(_torch_ranks.lowered_vs_live, 4, backend="gloo",
                     device="cpu", timeout_s=600, args=(cache, cases))


@pytest.mark.parametrize("name", list(LOWER_CASES))
def test_lowered_logs_equal_the_live_call(lowered_live, name):
    """A step lowered on meta arguments on a live mesh issues, traces and
    plans exactly what its live call does, on every rank; the live mesh
    touched no wire for the meta call (its result was meta)."""
    for r, got in enumerate(lowered_live):
        g = got[name]
        for low, live in zip(g["lowered"], g["live"]):
            assert collections.Counter(low) == collections.Counter(live), r
        assert g["signatures"][0] == g["signatures"][1]
        traced, executed = g["lowered"]
        assert traced and len(executed) >= len(traced)
        ops = {(op, axis) for op, axis, _, _ in traced}
        # the pinned three routes: primary all-reduces, staged and ortho
        # permutes, on both axes when the step reduces over data
        assert ("collective_permute", "model") in ops
        if LOWER_CASES[name]["kind"] == "train":
            assert ("collective_permute", "data") in ops
            assert len(executed) > len(traced)     # layer 1, recompute


# ---------------------------------------------------------------------------
# forward(remat="dots")
# ---------------------------------------------------------------------------

MM = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
      torch.ops.aten.addmm.default)


def _dots_case(arch):
    """The reference's reduced config, params and a batch."""
    from repro.configs import get_config as j_get
    from repro.models import init_params as j_init
    jcfg = j_get(arch).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, jp, batch


def _port_cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch).reduced()


def _port_grads(cfg, p, batch, remat):
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import lm_loss

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in MM:
                self.n += 1
            return func(*args, **(kwargs or {}))

    leaves, spec = torch.utils._pytree.tree_flatten(p)
    for x in leaves:
        x.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm_loss(p, tb, cfg, ParallelCtx(), remat=remat)
    with Count() as c:
        grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return float(loss.detach()), [g.numpy() for g in grads], c.n


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b"])
def test_remat_dots_matches_remat_true_and_the_reference(arch):
    """Loss and gradients under "dots" are those of remat=True and of the
    reference's "dots" (within 1e-5 / 1e-4); the backward recomputes no
    matmul under "dots" (its count is remat=False's) and every forward
    matmul of the checkpointed blocks under True."""
    from repro.models.transformer import lm_loss as j_loss
    from repro.models.tp import ParallelCtx as JCtx
    from repro_torch.convert import params_from_reference
    jcfg, jp, batch = _dots_case(arch)
    tcfg = _port_cfg(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, jb, jcfg, JCtx(), remat="dots")))(jp)
    jg = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    res = {}
    for remat in (False, True, "dots"):
        tp = params_from_reference(jax.tree.map(np.asarray, jp))
        res[remat] = _port_grads(tcfg, tp, batch, remat)
    loss, grads, n_dots = res["dots"]
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5, atol=1e-5)
    assert loss == res[True][0]
    for a, b in zip(grads, res[True][1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    n_none, n_full = res[False][2], res[True][2]
    assert n_dots == n_none < n_full


def test_encoder_stays_fully_checkpointed_under_dots():
    """Whisper's encoder blocks recompute their matmuls under "dots" (the
    reference's plain jax.checkpoint there); its decoder blocks do not."""
    cfg = _port_cfg("whisper-medium")
    from repro_torch.models.transformer import init_params
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["enc_embed"] = rng.normal(size=(2, cfg.encdec.n_frames,
                                          cfg.d_model)).astype(np.float32)
    counts = {r: _port_grads(cfg, p, batch, r)[2]
              for r in (False, True, "dots")}
    assert counts[False] < counts["dots"] < counts[True]


def test_forward_refuses_an_unknown_remat():
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import forward
    with pytest.raises(ValueError, match="remat"):
        forward({}, torch.zeros((1, 1), dtype=torch.int32),
                _port_cfg("glm4-9b"), ParallelCtx(), remat="all")


# ---------------------------------------------------------------------------
# the port-only dry-runs (the CLI, in the background)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_dry_run_finishes_ok(cli, name):
    rec, out = cli.get(name)
    assert rec["ok"] and rec["collective_structure"]
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"]
    assert "[OK  ] " in out
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["t_compute"] > 0 and r["t_memory"] > 0
    if name.startswith("cluster") or name == "pods":
        assert {"topology", "rollup", "a2a"} <= set(rec["cluster"])
        assert "[a2a] " in out
        assert any("@node" in k for k in rec["collective_structure"])
    if name == "pods":
        assert rec["mesh"] == "pods2-nodes2x8x16" and rec["chips"] == 512
        assert any("@pod" in k for k in rec["collective_structure"])
    if name == "cluster-mixtral":
        # mixtral's tp experts move no a2a bytes: no rail_balance printed
        assert rec["cluster"]["a2a"]["rail_balance"] is None
        assert "rail_balance" not in out
    if name == "compress":
        assert rec["compress"] == "secondary=fp8"
        assert "[wire] model/" in out and r["wire_scale"] < 1.0


def test_cli_fault_projection_equals_reference(cli):
    """The static fault table of an h100 cluster run equals the
    reference's FabricClock projection for the same timeline."""
    from repro.configs.clusters import resolve_faults
    from repro.faults import FabricClock
    rec, out = cli.get("cluster-glm4-fault")
    _, _, timeline = resolve_faults(None, 2, "h100", degrade="",
                                    fault="rail3@step200=0.25", pods=0)
    want = FabricClock(timeline).projection()
    assert rec["faults"] == want and len(want) == 1
    assert rec["fault"] == "rail3@step200=0.25"
    assert "[fault] step   200 degrade" in out
