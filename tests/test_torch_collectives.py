"""The port's data plane (multi-path collectives on torch process groups)
against the JAX reference.

Every case runs the reference's collective under ``shard_map`` on the
conftest's 8 CPU devices (a (4, 2) mesh, or (8,) for the butterfly) and
the port's on 8 gloo ranks with the same mesh shape, from the same global
input made with numpy.  All ranks run in ONE spawn for the whole module
(``launch.mesh.run_ranks``); the rank side lives in ``_torch_ranks.py``
and never imports JAX.  Rank r holds device r's block (the port's ranks
take ``jax.make_mesh`` coordinates, checked below).

* staged-only plans on random bf16 (and float32) payloads, ring
  reduce-scatter / all-gather / all-reduce with substeps {1, 2, 4}: bit
  for bit — the port keeps the reference's ring schedule and rounds
  through the fp32 accumulate (K1's plain version here, the Pallas kernel
  in interpret mode there) after every step;
* mixed primary/staged/ortho plans, all-to-all and the tree all-reduce:
  exact on small-integer payloads, since gloo's and XLA's sums run in
  different orders (DESIGN.md §9);
* staged rings with the bf16 pack on the wire, substeps {2, 4, 8}: bit
  for bit;
* the staged ring and the bf16-pack ring reduce (and pack) all
  sub-chunks of a ring step with ONE call of the kernels' list forms,
  counted on every rank for substeps {2, 4, 8}.

``RoutePlan`` equality and hash are compared on plans built by both.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_ranks
from repro.core import collectives as j_cx
from repro.core import routing as j_routing
from repro.core.topology import Collective as JColl
from repro_torch.core import routing as t_routing
from repro_torch.core.topology import Collective as TColl
from repro_torch.launch.mesh import run_ranks

SHARE_CASES = [
    {"primary": 100},
    {"primary": 80, "staged": 20},
    {"primary": 70, "staged": 20, "ortho": 10},
    {"primary": 0, "staged": 100},
    {"primary": 34, "staged": 33, "ortho": 33},
]
STAGED = {"primary": 0, "staged": 100}


def _small_ints(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 31, shape).astype(np.float32)


def _random_bf16(shape, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _cases():
    """name -> dict(op, kw, x, dtype, mesh, in_spec, out_spec)."""
    cases = {}

    def add(name, op, x, dtype, in_spec, out_spec, mesh="2d", **kw):
        cases[name] = dict(op=op, kw=kw, x=x, dtype=dtype, mesh=mesh,
                           in_spec=in_spec, out_spec=out_spec)

    for s in (1, 2, 4, 8):
        for dt in ("bfloat16", "float32"):
            x = _random_bf16((4 * 6, 40), s) if dt == "bfloat16" else \
                np.random.default_rng(s).standard_normal(
                    (4 * 6, 40)).astype(np.float32)
            add(f"staged-ar-{dt}-s{s}", "flex_all_reduce", x, dt, "data",
                "data", shares=STAGED, ortho_name="model", substeps=s)
        add(f"staged-rs-bfloat16-s{s}", "flex_reduce_scatter",
            _random_bf16((4 * 8, 36), 10 + s), "bfloat16", "none", "data",
            shares=STAGED, ortho_name="model", substeps=s)
        add(f"staged-ag-bfloat16-s{s}", "flex_all_gather",
            _random_bf16((4 * 3, 37), 20 + s), "bfloat16", "data", "none",
            shares=STAGED, ortho_name="model", substeps=s)
    for k, sh in enumerate(SHARE_CASES):
        tag = "-".join(f"{p[0]}{v}" for p, v in sh.items())
        for dt in ("float32", "bfloat16", "int32"):
            add(f"mixed-ar-{dt}-{tag}", "flex_all_reduce",
                _small_ints((4 * 6, 5), k), dt, "data", "data", shares=sh,
                ortho_name="model")
        add(f"mixed-ag-{tag}", "flex_all_gather", _small_ints((4 * 3, 7), k),
            "float32", "data", "none", shares=sh, ortho_name="model")
        add(f"mixed-rs-{tag}", "flex_reduce_scatter",
            _small_ints((4 * 8, 3), k), "float32", "none", "data", shares=sh,
            ortho_name="model")
        add(f"mixed-a2a-{tag}", "flex_all_to_all",
            _small_ints((4 * 8, 5), k), "float32", "data", "data", shares=sh,
            ortho_name="model")
    # payload that differs across the ortho axis (sharded over both axes)
    for sh in ({"primary": 60, "staged": 20, "ortho": 20},
               {"primary": 0, "ortho": 100}):
        tag = "-".join(f"{p[0]}{v}" for p, v in sh.items())
        add(f"ortho-sharded-ar-{tag}", "flex_all_reduce",
            _small_ints((4 * 2, 6), 40), "float32", "data,model",
            "data,model", shares=sh, ortho_name="model")
    add("ortho-sharded-ag", "flex_all_gather", _small_ints((4 * 3, 4), 41),
        "float32", "data,model", "none,model",
        shares={"primary": 70, "staged": 15, "ortho": 15}, ortho_name="model")
    for s, dt in ((2, "float32"), (4, "float32"), (8, "float32"),
                  (4, "bfloat16")):
        x = np.random.default_rng(50 + s).standard_normal(
            (4 * 6, 40)).astype(np.float32)
        if dt == "bfloat16":
            x = _random_bf16((4 * 6, 40), 50 + s)
        add(f"bf16pack-ar-{dt}-s{s}", "codec_execute", x, dt, "data", "data",
            collective="all_reduce", shares=STAGED, substeps=s,
            codec="bf16_pack")
    add("ring-ag", "ring_all_gather", _small_ints((4 * 2, 3), 42), "float32",
        "data", "none")
    add("ring-ar", "ring_all_reduce", _small_ints((4 * 5,), 43), "float32",
        "data", "data")
    add("tree-ar", "tree_all_reduce", _small_ints((8 * 6,), 44), "float32",
        "data", "data", mesh="1d")
    return cases


CASES = _cases()


def _j_spec(spec):
    from jax.sharding import PartitionSpec as P
    axes = {"data": "x", "model": "y", "none": None}
    return P(*[axes[a] for a in spec.split(",")])


def _reference(case):
    """The JAX collective's global output, as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.compat import shard_map
    devs = np.asarray(jax.devices()[:8])
    if case["mesh"] == "1d":
        mesh = Mesh(devs.reshape(8), ("x",))
    else:
        mesh = Mesh(devs.reshape(4, 2), ("x", "y"))
    kw = dict(case["kw"])
    if "ortho_name" in kw:
        kw["ortho_name"] = "y"
    if case["op"] == "codec_execute":
        plan = j_routing.build_plan(
            JColl(kw["collective"]), "x", kw["shares"], "y",
            staged_substeps=kw["substeps"],
            path_codecs={"staged": kw["codec"]})
        kw = {}
    fn = {"flex_all_reduce": j_cx.flex_all_reduce,
          "flex_all_gather": functools.partial(j_cx.flex_all_gather,
                                               tiled=True),
          "flex_reduce_scatter": j_cx.flex_reduce_scatter,
          "flex_all_to_all": j_cx.flex_all_to_all,
          "ring_all_gather": j_cx.ring_all_gather,
          "ring_all_reduce": j_cx.ring_all_reduce,
          "tree_all_reduce": j_cx.tree_all_reduce,
          "codec_execute": lambda v, _: j_routing.execute(plan, v)
          }[case["op"]]
    f = shard_map(lambda v: fn(v, "x", **kw), mesh=mesh,
                  in_specs=(_j_spec(case["in_spec"]),),
                  out_specs=_j_spec(case["out_spec"]),
                  check_vma=False)
    x = jnp.asarray(case["x"]).astype(case["dtype"])
    return np.asarray(jax.jit(f)(x).astype(jnp.float32)
                      if case["dtype"] != "int32" else jax.jit(f)(x))


def _expected_block(glob, spec, coords, shape):
    """Rank block of a global output under a PartitionSpec-like spec."""
    axis_of = {"data": 0, "model": 1}
    for dim, a in enumerate(spec.split(",")):
        if a == "none":
            continue
        n, i = shape[axis_of[a]], coords[axis_of[a]]
        size = glob.shape[dim] // n
        glob = np.take(glob, range(i * size, (i + 1) * size), axis=dim)
    return glob


@pytest.fixture(scope="module")
def port_results():
    """Every case on 8 gloo ranks, in one spawn."""
    return run_ranks(_torch_ranks.collectives, 8, backend="gloo",
                     device="cpu", timeout_s=240, args=(CASES,))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_reference(port_results, name):
    case = CASES[name]
    want = _reference(case)
    shape = _torch_ranks.MESHES[case["mesh"]][0]
    for r, res in enumerate(port_results):
        coords = np.unravel_index(r, shape)
        exp = _expected_block(want, case["out_spec"], coords, shape)
        got = res[name]
        assert got.shape == exp.shape, (r, got.shape, exp.shape)
        # bit for bit (bf16 widened to float32 exactly, -0.0 != +0.0)
        np.testing.assert_array_equal(_bits(got), _bits(exp.astype(got.dtype)),
                                      err_msg=f"rank {r}")


#: (case, per-rank calls of the COUNTED ops functions) on the data axis of
#: the (4, 2) mesh: n - 1 = 3 reduce steps a ring, each one list-form
#: call, whatever the substeps; the bf16 pack also packs the all-gather's
#: source once
RING_CALLS = {
    **{f"staged-{op}-bfloat16-s{s}": {"accumulate_many": 3}
       for op in ("ar", "rs") for s in (2, 4, 8)},
    **{f"bf16pack-ar-{dt}-s{s}": {"accumulate_many": 3,
                                   "wire_encode_many": 4}
       for dt, s in (("float32", 2), ("float32", 4), ("float32", 8),
                     ("bfloat16", 4))}}


@pytest.mark.parametrize("name", sorted(RING_CALLS))
def test_ring_calls_list_form_once_per_step(port_results, name):
    assert name in CASES
    for r, res in enumerate(port_results):
        assert res["calls"][name] == RING_CALLS[name], f"rank {r}"


def test_concat_is_a_view_of_a_list_forms_buffer():
    """The reduce-scatter's last step hands back the list form's buffer:
    its sub-chunks laid end to end are that buffer, with no copy; other
    parts are concatenated."""
    from repro_torch.core.collectives import _concat
    from repro_torch.kernels import ops as tops
    a = [torch.full((5,), float(j), dtype=torch.bfloat16) for j in range(3)]
    parts = tops.accumulate_many(a, a)
    joined = _concat(parts)
    assert joined.data_ptr() == parts[0].data_ptr()
    assert torch.equal(joined, torch.cat(parts))
    fresh = [p.clone() for p in parts]
    assert torch.equal(_concat(fresh), joined)
    assert _concat(fresh).data_ptr() != fresh[0].data_ptr()
    assert _concat(parts[:2]).data_ptr() != parts[0].data_ptr()


def test_rank_coordinates_follow_make_mesh(port_results):
    """Rank r sits where jax.make_mesh puts device r."""
    import jax
    for name, (shape, axes) in _torch_ranks.MESHES.items():
        jm = jax.make_mesh(shape, axes)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r, res in enumerate(port_results):
            assert ids[res["coords"][name]] == r


PLAN_CASES = [(op, sh, ortho, s, acc)
              for op in ("all_reduce", "all_gather", "reduce_scatter",
                         "all_to_all")
              for sh in SHARE_CASES + [None]
              for ortho in ("model", None)
              for s in (1, 2, 4, 16)
              for acc in ("auto", "native")]


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter",
                                "all_to_all"])
def test_route_plan_equality_and_hash(op):
    for _, sh, ortho, s, acc in [c for c in PLAN_CASES if c[0] == op]:
        jp = j_routing.build_plan(JColl(op), "data", sh, ortho,
                                  staged_substeps=s, accumulate=acc)
        tp = t_routing.build_plan(TColl(op), "data", sh, ortho,
                                  staged_substeps=s, accumulate=acc)
        jt = tuple((f, getattr(jp, f)) for f in jp.__dataclass_fields__)
        tt = tuple((f, getattr(tp, f)) for f in tp.__dataclass_fields__)
        assert tt[1:] == jt[1:] and tt[0][1].value == jt[0][1].value
        assert hash(tp) == hash(jp)
        assert (tp.paths, tp.is_primary_only, tp.units()) == \
            (jp.paths, jp.is_primary_only, jp.units())


def test_resolve_accumulate_follows_the_reference_policy():
    """ACC_AUTO: the kernel for sub-32-bit floats only; KERNEL_FP32 forces
    it on floats and refuses integers; NATIVE never."""
    import jax.numpy as jnp
    for acc in ("auto", "kernel_fp32", "native"):
        jp = j_routing.build_plan(JColl.ALL_REDUCE, "data", STAGED,
                                  accumulate=acc)
        tp = t_routing.build_plan(TColl.ALL_REDUCE, "data", STAGED,
                                  accumulate=acc)
        for jd, td in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float16, torch.float16),
                       (jnp.float32, torch.float32),
                       (jnp.int32, torch.int32)):
            try:
                jr = j_routing.resolve_accumulate(jp, jd) is not None
            except TypeError:
                jr = TypeError
            try:
                tr = t_routing.resolve_accumulate(tp, td) is not None
            except TypeError:
                tr = TypeError
            assert tr == jr, (acc, td)
