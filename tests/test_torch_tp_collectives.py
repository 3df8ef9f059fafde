"""The port's differentiable model-axis collectives against the reference.

On a (data=2, model=4) mesh, ``tp_all_reduce``, ``tp_all_gather``
(tiled), ``tp_reduce_scatter`` and ``tp_psum_small`` of a ParallelCtx,
and ``ep_all_to_all`` (the MoE dispatch over the data axis, split and
concat on axis 0), run
forward and backward on 8 gloo ranks (rank side in ``_torch_ranks.py``,
spawned once) and, on the same small-integer float32 payloads, inside the
reference's ``shard_map(check_vma=False)`` on 8 CPU devices.  The loss
is ``sum(out * out * w)`` with a weight ``w = rank + 1`` that differs
across ranks, so a wrong transpose shows.  The communicators warm-start
from a TuningProfile that pins the model axis's slots to primary, staged
and ortho routes, so the multi-route plans (asserted) run forward and
transposed; the data axis's all_to_all slot is pinned likewise, so its
primary collective and the staged ring run forward and in the backward
(an all_to_all is its own transpose).  Forward results and gradients are
exact (sums of small
integers), so they must be equal bit for bit; the model axis's plan
and data axes' plan signatures equal the reference's.  Backward calls
and calls inside
``ctx.unrecorded()`` record nothing.

Also the reference's codec VJP test (tests/test_codecs.py:213-225): the
gradient of the staged ring all-gather and all-reduce (staged-only plans)
under ``bf16_pack`` equals the uncompressed one and the reference's.
"""

import numpy as np
import pytest

import _torch_ranks
from repro.core import communicator as j_comm
from repro_torch.launch.mesh import run_ranks

PROFILE = "h800"
SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}
OPS = ("all_reduce", "all_gather", "reduce_scatter")
ROWS = 8              # rows of each rank's [ROWS, COLS] payload
COLS = 12
CASES = {f"tp_{op}": op for op in OPS}
CASES["tp_psum_small"] = "psum_small"
CASES["ep_all_to_all"] = "ep_all_to_all"


def _payload(seed, rows, cols):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 8, size=(rows, cols)).astype(np.float32)


@pytest.fixture(scope="module")
def comm(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "pinned.json")
    _torch_ranks.pinned_profile(path, PROFILE, 4, SHARES, ops=OPS)
    _torch_ranks.pinned_profile(path, PROFILE, 2, SHARES,
                                ops=("all_to_all",))
    return {"profile": PROFILE, "tuning_cache": path}


def _codec_cases():
    x = (np.arange(8 * 6, dtype=np.float32) % 17)
    return {f"{op}-{codec or 'raw'}": {"op": op, "codec": codec, "x": x}
            for op in ("all_gather", "all_reduce")
            for codec in ("", "bf16_pack")}


@pytest.fixture(scope="module")
def port(comm):
    cases = {name: {"op": f"tp_{op}" if op == "psum_small" else name,
                    "x": _payload(i, 8 * ROWS, COLS)}
             for i, (name, op) in enumerate(CASES.items())}
    res = run_ranks(_torch_ranks.tp_collectives, 8, backend="gloo",
                    device="cpu", timeout_s=300,
                    args=(cases, comm, _codec_cases()))
    return cases, res


@pytest.fixture(scope="module")
def reference(port, comm):
    """Per case, the reference's per-rank outputs and the gradient of the
    summed weighted loss inside shard_map(check_vma=False), stacked by
    rank, all on one ctx; and that ctx's plan signature."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.models.tp import ParallelCtx
    cases, _ = port
    j_comm.comm_destroy_all()
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    ctx = ParallelCtx(tp_axis="model", dp_axis="data", tp_size=4, dp_size=2,
                      comm_config=j_comm.CommConfig(**comm))
    spec = P(("data", "model"))
    out = {}
    for name, c in cases.items():
        def shard(xs, op=c["op"]):
            if op == "ep_all_to_all":
                y = ctx.ep_all_to_all(xs, split_axis=0, concat_axis=0)
            else:
                y = getattr(ctx, op)(xs)
            w = (lax.axis_index("data") * 4 + lax.axis_index("model")
                 + 1).astype(jnp.float32)
            return y, jnp.sum(y * y * w)[None]

        f = jax.jit(shard_map(shard, mesh=mesh, in_specs=(spec,),
                              out_specs=(spec, spec), check_vma=False))
        xj = jnp.asarray(c["x"])
        out[name] = (np.asarray(f(xj)[0]),
                     np.asarray(jax.grad(lambda xs: jnp.sum(f(xs)[1]))(xj)))
    out["signature"] = tuple((a, _torch_ranks.plain_signature(s))
                             for a, s in ctx.plan_signature())
    j_comm.comm_destroy_all()
    return out


def _ref_codec_grad(op, codec, x):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.core import collectives as mp
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("x",))

    def shard(xs):
        out = getattr(mp, f"ring_{op}")(xs, "x", codec=codec)
        w = lax.axis_index("x").astype(jnp.float32) + 1.0
        return jnp.sum(out * out * w)[None]

    f = shard_map(shard, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                  check_vma=False)
    return np.asarray(jax.grad(lambda xs: jnp.sum(jax.jit(f)(xs)))(
        jnp.asarray(x)))


def _by_rank(a, n=8):
    return np.split(a, n)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_grad_match_reference(port, reference, name):
    _, res = port
    y, g = reference[name]
    for r, (yr, gr) in enumerate(zip(_by_rank(y), _by_rank(g))):
        np.testing.assert_array_equal(res[r][name]["y"], yr,
                                      err_msg=f"rank {r} forward")
        np.testing.assert_array_equal(res[r][name]["grad"], gr,
                                      err_msg=f"rank {r} grad")
    assert np.any(g != 0)


def test_plans_are_multi_route_and_match_reference(port, reference):
    """The model axis's slots run primary, staged and ortho routes, and
    both packages sign them alike (the data axis made no call)."""
    _, res = port
    sig = reference["signature"]
    model = dict(res[0]["signature"])["model"]
    assert len(model) == len(OPS)
    for _, _, plan in model:
        units = dict(dict(plan)["chunk_units"])
        assert set(units) == {"primary", "staged", "ortho"}, units
    assert all(r["signature"] == res[0]["signature"] for r in res)
    assert dict(res[0]["signature"])["model"] == dict(sig)["model"]


def test_all_to_all_plan_is_two_route_and_matches_reference(port,
                                                            reference):
    """The data axis's all_to_all slot runs the primary collective and the
    staged ring (its ortho share folds into staged), and both packages
    sign it alike."""
    _, res = port
    data = dict(res[0]["signature"])["data"]
    assert [op for op, _, _ in data] == ["all_to_all"]
    units = dict(dict(data[0][2])["chunk_units"])
    assert set(units) == {"primary", "staged"}, units
    assert data == dict(reference["signature"])["data"]


@pytest.mark.parametrize("name", [n for n in CASES if n != "tp_psum_small"])
def test_backward_and_unrecorded_calls_record_nothing(port, name):
    """One forward call records one call; the backward (the transpose
    collective) and a repeat inside ``ctx.unrecorded()`` add none, and
    the repeat gives the same result."""
    _, res = port
    for r in res:
        assert r[name]["recorded"] == (1, 1), r[name]["recorded"]
        assert r[name]["unrecorded_equal"]


@pytest.mark.parametrize("op", ["all_gather", "all_reduce"])
def test_codec_grads_match_uncompressed_and_reference(port, op):
    """Straight-through: the bf16_pack plan's gradient equals the raw
    plan's and the reference's ring primitive's, on every rank; the
    forward (bf16-exact integers) is unchanged by the codec."""
    _, res = port
    cases = _codec_cases()
    plain, packed = f"{op}-raw", f"{op}-bf16_pack"
    want = _by_rank(_ref_codec_grad(op, "bf16_pack", cases[packed]["x"]))
    want_raw = _by_rank(_ref_codec_grad(op, "", cases[plain]["x"]))
    for r, got in enumerate(res):
        assert got[packed]["codecs"] == (("staged", "bf16_pack"),)
        np.testing.assert_array_equal(got[packed]["y"], got[plain]["y"])
        np.testing.assert_array_equal(got[packed]["grad"],
                                      got[plain]["grad"])
        np.testing.assert_array_equal(got[packed]["grad"], want[r])
        np.testing.assert_array_equal(got[plain]["grad"], want_raw[r])
        assert np.any(got[packed]["grad"] != 0)
