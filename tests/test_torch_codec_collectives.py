"""The port's compressed collectives (wire codecs on the secondary routes)
against the JAX reference, bit for bit.

Each case builds the same plan with ``path_codecs`` in both packages and
runs it through ``routing.execute`` (or the butterfly all-reduce with a
codec): the reference under ``shard_map`` on the conftest's 8 CPU
devices, with its Pallas codec kernels in interpret mode; the port on 8
gloo ranks in ONE spawn (rank side in ``_torch_ranks.py``, which never
imports JAX), with the codec kernels' plain versions.  Inputs are random
float32 or bfloat16 made with numpy, so the fp8 and bf16 encodings do
real rounding.  Every result is compared bit for bit: the rings and the
butterfly keep the reference's schedule and roundings, and plans with a
primary share run on the (data=2, model=4) mesh, where the native sum of
two values rounds once in any order.

The communicator cases of tests/test_codecs.py (codec choice per slot,
plans and signatures that carry the codec, the report's wire-byte
breakout, compressed cold -> save -> warm TuningProfile cycles) run on
the control plane in this process and must equal the reference's.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import _torch_ranks
from repro.core import communicator as j_comm
from repro.core import collectives as j_cx
from repro.core import routing as j_routing
from repro.core.links import PROFILES as J_PROFILES
from repro.core.links import degrade_profile as j_degrade
from repro.core.topology import Collective as JColl
from repro_torch.core import communicator as t_comm
from repro_torch.core import routing as t_routing
from repro_torch.core.links import PROFILES as T_PROFILES
from repro_torch.core.links import degrade_profile as t_degrade
from repro_torch.core.topology import Collective as TColl
from repro_torch.launch.mesh import run_ranks

MiB = 1 << 20
AR = "all_reduce"
STAGED = {"primary": 0, "staged": 100}
ORTHO = {"primary": 0, "ortho": 100}
MIXED = {"primary": 50, "staged": 25, "ortho": 25}


def _random(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    # groups of very different magnitude, so scales differ per group
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, size=shape[:1] + (1,) * (len(shape) - 1))
                ).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _cases():
    cases = {}

    def add(name, op, codec, dtype, shape, in_spec, out_spec, mesh="2d",
            shares=STAGED, substeps=2):
        seed = len(cases)
        cases[name] = dict(op=op, codec=codec, dtype=dtype, mesh=mesh,
                           x=_random(shape, dtype, seed), shares=shares,
                           substeps=substeps, in_spec=in_spec,
                           out_spec=out_spec)

    combos = [("fp8_e4m3", "float32"), ("fp8_e4m3", "bfloat16"),
              ("fp8_e5m2", "float32"), ("bf16_pack", "float32"),
              ("bf16_pack", "bfloat16")]
    for codec, dt in combos:
        tag = f"{codec}-{dt}"
        add(f"ring-ar-{tag}", AR, codec, dt, (4 * 6, 300), "data", "data")
        add(f"ring-rs-{tag}", "reduce_scatter", codec, dt, (4 * 8, 70),
            "none", "data", substeps=1)
        add(f"ring-ag-{tag}", "all_gather", codec, dt, (4 * 3, 90), "data",
            "none")
        add(f"tree-ar-{tag}", "tree_all_reduce", codec, dt, (8 * 130,),
            "data", "data", mesh="1d")
        add(f"ortho-ar-{tag}", AR, codec, dt, (2 * 4, 152), "data,model",
            "data,model", mesh="2x4", shares=ORTHO)
        add(f"mixed-ar-{tag}", AR, codec, dt, (2 * 5, 260), "data", "data",
            mesh="2x4", shares=MIXED)
    for codec, dt in combos[:2] + combos[3:4]:
        tag = f"{codec}-{dt}"
        add(f"ring-a2a-{tag}", "all_to_all", codec, dt, (4 * 8, 40), "data",
            "data")
        add(f"ortho-ag-{tag}", "all_gather", codec, dt, (2 * 3, 140),
            "data,model", "none,model", mesh="2x4", shares=ORTHO)
        add(f"mixed-ag-{tag}", "all_gather", codec, dt, (2 * 3, 300), "data",
            "none", mesh="2x4", shares=MIXED)
    return cases


CASES = _cases()


def _j_spec(spec):
    from jax.sharding import PartitionSpec as P
    axes = {"data": "x", "model": "y", "none": None}
    return P(*[axes[a] for a in spec.split(",")])


def _reference(case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.compat import shard_map
    shape, _ = _torch_ranks.MESHES[case["mesh"]]
    devs = np.asarray(jax.devices()[:8])
    mesh = Mesh(devs.reshape(shape), ("x", "y")[:len(shape)])
    if case["op"] == "tree_all_reduce":
        fn = functools.partial(j_cx.tree_all_reduce, axis_name="x",
                               codec=case["codec"])
    else:
        plan = j_routing.build_plan(
            JColl(case["op"]), "x", case["shares"], "y",
            staged_substeps=case["substeps"],
            path_codecs={"staged": case["codec"], "ortho": case["codec"]})
        fn = functools.partial(j_routing.execute, plan)
    f = shard_map(fn, mesh=mesh, in_specs=(_j_spec(case["in_spec"]),),
                  out_specs=_j_spec(case["out_spec"]), check_vma=False)
    x = jnp.asarray(case["x"]).astype(case["dtype"])
    return np.asarray(jax.jit(f)(x).astype(jnp.float32))


def _expected_block(glob, spec, coords, shape):
    for dim, a in enumerate(spec.split(",")):
        if a == "none":
            continue
        k = {"data": 0, "model": 1}[a]
        size = glob.shape[dim] // shape[k]
        glob = np.take(glob, range(coords[k] * size, (coords[k] + 1) * size),
                       axis=dim)
    return glob


@pytest.fixture(scope="module")
def port_results():
    """Every case on 8 gloo ranks, in one spawn."""
    return run_ranks(_torch_ranks.codec_collectives, 8, backend="gloo",
                     device="cpu", timeout_s=240, args=(CASES,))


@pytest.mark.parametrize("name", sorted(CASES))
def test_codec_collective_matches_reference(port_results, name):
    case = CASES[name]
    want = _reference(case)
    shape, _ = _torch_ranks.MESHES[case["mesh"]]
    lossy = not (case["codec"] == "bf16_pack" and case["dtype"] == "bfloat16")
    assert not lossy or not np.array_equal(want, _exact(case)), \
        "the codec changed nothing: the case does not test the codec"
    for r, res in enumerate(port_results):
        coords = np.unravel_index(r, shape)
        exp = _expected_block(want, case["out_spec"], coords, shape)
        got = res[name]
        assert got.shape == exp.shape, (r, got.shape, exp.shape)
        np.testing.assert_array_equal(got.view(np.int32),
                                      exp.astype(np.float32).view(np.int32),
                                      err_msg=f"rank {r}")


def _exact(case):
    """The same plan without codecs, for the check that a codec rounded."""
    return _reference(dict(case, codec=""))


def test_codec_gather_rows_equal_on_every_rank(port_results):
    """The compressed all-gather encodes once at the source: every rank
    holds the same rows (the mesh's data axis lines hold one result)."""
    for name in CASES:
        if CASES[name]["op"] != "all_gather" or CASES[name]["mesh"] != "2d":
            continue
        got = [res[name] for res in port_results]
        for r in range(1, 8):
            if r % 2 == 0:                 # same model coordinate as rank 0
                np.testing.assert_array_equal(got[r], got[0])


# ---------------------------------------------------------------------------
# the communicator's codec control plane (tests/test_codecs.py:297-450)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _fresh_comms():
    j_comm.comm_destroy_all()
    t_comm.comm_destroy_all()
    yield
    j_comm.comm_destroy_all()
    t_comm.comm_destroy_all()


def _both(axis, n, **cfg):
    return (j_comm.comm_init_rank(axis, n, j_comm.CommConfig(**cfg)),
            t_comm.comm_init_rank(axis, n, t_comm.CommConfig(**cfg)))


def _same_plans(jc, tc, sizes, ops=(AR,)):
    for op in ops:
        for size in sizes:
            jp = jc._bucket_plan(JColl(op), size)
            tp = t_comm.FlexCommunicator._bucket_plan(tc, TColl(op), size)
            assert jp.chunk_units == tp.chunk_units, (op, size)
            assert jp.path_codecs == tp.path_codecs, (op, size)
            assert jp.staged_substeps == tp.staged_substeps, (op, size)
    plain = _torch_ranks.plain_signature
    assert plain(tc.plan_signature()) == plain(jc.plan_signature())


def test_degraded_profile_names_agree():
    assert t_degrade(T_PROFILES["h800"], "nvlink=0.1").name == \
        j_degrade(J_PROFILES["h800"], "nvlink=0.1").name == "h800!nvlink=0.1"


@pytest.mark.parametrize("compress", ["", "secondary=fp8", "secondary=bf16",
                                      "staged=fp8_e5m2,ortho=bf16"])
@pytest.mark.parametrize("profile,n", [("h800", 8), ("h800!nvlink=0.1", 2),
                                       ("h800!nvlink=0.1", 8), ("h100", 2),
                                       ("h100", 4)])
def test_codec_choice_plans_and_report_equal_reference(profile, n, compress):
    j_degrade(J_PROFILES["h800"], "nvlink=0.1")
    t_degrade(T_PROFILES["h800"], "nvlink=0.1")
    jc, tc = _both("data", n, profile=profile, compress=compress)
    sizes = [4 * 1024, MiB, 4 * MiB, 16 * MiB, 64 * MiB, 256 * MiB,
             1024 * MiB]
    _same_plans(jc, tc, sizes, ops=(AR, "all_gather", "reduce_scatter"))
    for size in sizes:
        assert tc.slot_codecs(TColl.ALL_REDUCE, size) == \
            jc.slot_codecs(JColl.ALL_REDUCE, size)
    assert json.dumps(tc.report(), sort_keys=True, default=str) == \
        json.dumps(jc.report(), sort_keys=True, default=str)


def test_full_width_glm4_leaves_carry_fp8_at_two_ranks():
    """At glm4-9b's published widths (2 layers, bf16) on the h100 profile,
    the big gradient leaves' plans carry fp8 on the staged route at 2
    ranks; the same plans as the reference's."""
    jc, tc = _both("data", 2, profile="h100", compress="secondary=fp8")
    leaves = {"embed": 151552 * 4096 * 2, "mlp": 2 * 4096 * 13696 * 2,
              "wq": 2 * 4096 * 4096 * 2}
    for name, nbytes in leaves.items():
        b = t_comm.bucket_for(nbytes)
        tp = tc._bucket_plan(TColl.ALL_REDUCE, b)
        jp = jc._bucket_plan(JColl.ALL_REDUCE, b)
        assert tp.path_codecs == jp.path_codecs == \
            (("staged", "fp8_e4m3"),), (name, tp)
        assert tp.chunk_units == jp.chunk_units


def test_compressed_cold_warm_cycle_json_identical(tmp_path):
    """A compressed cold tune saves byte-identical TuningProfile JSON to
    the reference's, and the warm start runs zero Stage-1 iterations with
    the saved codec choice and plans."""
    deg = "h800!nvlink=0.1"
    j_degrade(J_PROFILES["h800"], "nvlink=0.1")
    t_degrade(T_PROFILES["h800"], "nvlink=0.1")
    paths = {k: str(tmp_path / f"{k}.json") for k in ("j", "t")}
    sizes = (64 * 1024, 4 * MiB, 64 * MiB, 256 * MiB)
    sigs = {}
    for k, mod in (("j", j_comm), ("t", t_comm)):
        cfg = mod.CommConfig(profile=deg, compress="secondary=fp8",
                             tuning_cache=paths[k])
        cold = mod.comm_init_rank("w", 8, cfg)
        coll = (JColl if k == "j" else TColl).ALL_REDUCE
        for size in sizes:
            assert not cold.slot(coll, size).warm
        sigs[k] = _torch_ranks.plain_signature(cold.plan_signature())
        cold.save_tuning()
        mod.comm_destroy_all()
        warm = mod.comm_init_rank("w", 8, cfg)
        for size in sizes:
            sc = warm.slot(coll, size)
            assert sc.warm and sc.tuned.iterations == 0
        assert _torch_ranks.plain_signature(warm.plan_signature()) == \
            sigs[k]
    assert sigs["t"] == sigs["j"]
    with open(paths["j"]) as fj, open(paths["t"]) as ft:
        raw_j, raw_t = fj.read(), ft.read()
    assert raw_t == raw_j
    entries = json.loads(raw_t)["entries"]
    assert all("fp8_e4m3" in e["secondary_algo"] for e in entries)
    assert any(e["codecs"] == {} for e in entries)   # the tiny slot
    assert any(e["codecs"] for e in entries)


def test_uncompressed_cache_file_has_no_codec_fields(tmp_path):
    path = str(tmp_path / "tune.json")
    comm = t_comm.comm_init_rank("u", 8, t_comm.CommConfig(
        profile="h800", tuning_cache=path))
    comm.slot(TColl.ALL_REDUCE, 64 * MiB)
    comm.save_tuning()
    raw = open(path).read()
    assert "codecs" not in raw and "fp8" not in raw
    assert os.path.getsize(path) > 0
