"""The port's GradBucketer against the JAX reference's (pure metadata).

The three packing tests of tests/test_overlap.py, ported; then the port's
bucket plan (tags, each piece's leaf, rows and bytes, each bucket's bytes,
dtype and expert flag) held equal to the reference ``GradBucketer``'s for
the same trees: those tests' trees, reduced glm4-9b, and full-width
glm4-9b at depth 2 at ``bucket_mb`` 25 / 64 / 256 (107 / 47 / 14
buckets), where the port gets meta-device tensors of the shapes
``jax.eval_shape`` gives the reference, so nothing is allocated at full
width.  JAX flattens a dict by sorted key and the port's ``init_params``
inserts ``embed, final_norm, lm_head, layers``: both insertion orders
must give the reference's plan, and results come back in the caller's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.bucketer import GradBucketer as JBucketer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models.tp import ParallelCtx
from repro_torch.models.transformer import init_params as t_init_params
from repro_torch.train.bucketer import GradBucketer, tree_paths

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mb(nbytes: int) -> float:
    return nbytes / 2.0 ** 20


def _plan(b):
    """A bucket plan of either package as plain data."""
    return [(bk.tag, tuple((p.leaf, p.rows, p.nbytes) for p in bk.pieces),
             bk.nbytes, bk.dtype, bk.expert) for bk in b.buckets]


def _meta(shapes, order=None):
    """Meta tensors of a tree of ``jax.ShapeDtypeStruct``s, nested in the
    key order of ``order`` (a tree with the same keys) when given."""
    order = shapes if order is None else order
    if isinstance(order, dict):
        return {k: _meta(shapes[k], order[k]) for k in order}
    return torch.empty(shapes.shape, dtype=DTYPES[str(shapes.dtype)],
                       device="meta")


def _port_order():
    """The key order of the port's ``init_params`` (any width)."""
    return t_init_params(get_config("glm4-9b").reduced(),
                         torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# packing rules (tests/test_overlap.py, ported)
# ---------------------------------------------------------------------------

def test_bucketer_splits_big_leaves_and_respects_target():
    grads = {"big": torch.zeros((16, 32)),       # 2048 B, 128 B/row
             "small": torch.zeros((4,))}         # 16 B
    b = GradBucketer(grads, bucket_mb=_mb(512))
    assert sum(bk.nbytes for bk in b.buckets) == 16 * 32 * 4 + 4 * 4
    assert all(bk.nbytes <= 512 for bk in b.buckets)
    assert [bk.tag for bk in b.buckets] == \
        [f"g{i}" for i in range(len(b.buckets))]
    # reverse leaf order: the LAST leaf ("small") leads the issue order
    first = b.buckets[0].pieces[0]
    assert b.leaves(grads)[first.leaf].shape == (4,)
    # slabs of the split leaf are issued end-of-stack first
    slabs = [p.rows for bk in b.buckets for p in bk.pieces
             if p.rows is not None]
    assert slabs == sorted(slabs, reverse=True)


def test_bucketer_dtype_and_expert_homogeneity():
    grads = {"a": torch.zeros((8, 8)),
             "moe": {"experts": {"w": torch.zeros((8, 8))}},
             "z": torch.zeros((8, 8), dtype=torch.bfloat16)}
    b = GradBucketer(grads, bucket_mb=1.0, ep=True)
    assert len(b.buckets) == 3
    assert {(bk.dtype, bk.expert) for bk in b.buckets} == \
        {("bfloat16", False), ("float32", True), ("float32", False)}
    assert len(GradBucketer(grads, bucket_mb=1.0, ep=False).buckets) == 2


def test_bucketer_rejects_zero_and_roundtrips_without_comms():
    grads = {"w": torch.arange(64, dtype=torch.float32).reshape(16, 4),
             "b": torch.arange(5, dtype=torch.float32)}
    with pytest.raises(ValueError):
        GradBucketer(grads, bucket_mb=0.0)
    # no live communicators: every reduce is the identity, so sync is the
    # slice/concat identity, bit-exact, in the caller's key order
    out = GradBucketer(grads, bucket_mb=_mb(64)).sync(grads, ParallelCtx())
    assert list(out) == ["w", "b"]
    for k in grads:
        assert torch.equal(out[k], grads[k])


# ---------------------------------------------------------------------------
# the port's plan == the reference's
# ---------------------------------------------------------------------------

def _packing_trees():
    f32, bf16 = np.float32, jnp.bfloat16
    return [
        ({"big": ((16, 32), f32), "small": ((4,), f32)}, _mb(512), False),
        ({"a": ((8, 8), f32), "moe": {"experts": {"w": ((8, 8), f32)}},
          "z": ((8, 8), bf16)}, 1.0, True),
        ({"a": ((8, 8), f32), "moe": {"experts": {"w": ((8, 8), f32)}},
          "z": ((8, 8), bf16)}, 1.0, False),
        ({"w": ((16, 4), f32), "b": ((5,), f32)}, _mb(64), False),
        # a split stack between whole leaves, both dtypes, keys that sort
        # against their insertion order
        ({"z": ((40, 3), f32), "m": {"y": ((7, 9), bf16),
                                     "b": ((2, 5), f32)},
          "a": ((3,), f32)}, _mb(100), False),
    ]


def _build(spec, make):
    if isinstance(spec, dict):
        return {k: _build(v, make) for k, v in spec.items()}
    return make(*spec)


@pytest.mark.parametrize("case", range(5))
def test_plan_matches_reference_on_packing_trees(case):
    spec, mb, ep = _packing_trees()[case]
    jt = _build(spec, lambda shape, dt: jnp.zeros(shape, dt))
    tt = _build(spec, lambda shape, dt: torch.zeros(
        shape, dtype=DTYPES[str(jnp.dtype(dt))]))
    assert _plan(GradBucketer(tt, bucket_mb=mb, ep=ep)) == \
        _plan(JBucketer(jt, bucket_mb=mb, ep=ep))


@pytest.mark.parametrize("bucket_mb", [0.05, 0.25, 1.0])
def test_plan_matches_reference_reduced_glm4(bucket_mb):
    """Reduced glm4-9b: the reference's tree converted to the port, and
    the port's own ``init_params`` tree (its insertion order)."""
    from repro.configs import get_config as j_get_config
    from repro.models import init_params
    jp = init_params(jax.random.PRNGKey(0),
                     j_get_config("glm4-9b").reduced())
    want = _plan(JBucketer(jp, bucket_mb=bucket_mb))
    assert len(want) > 1
    converted = params_from_reference(jax.tree.map(np.asarray, jp))
    own = _port_order()
    assert list(own) != sorted(own)
    for tree in (converted, own):
        assert _plan(GradBucketer(tree, bucket_mb=bucket_mb)) == want


@pytest.mark.parametrize("bucket_mb,n_buckets", [(25, 107), (64, 47),
                                                 (256, 14)])
def test_plan_matches_reference_full_width_glm4(bucket_mb, n_buckets):
    """Full-width glm4-9b at depth 2 (3146 MiB of bf16 gradients), in
    either key order, from meta tensors."""
    from repro.configs import get_config as j_get_config
    from repro.models import init_params
    cfg = dataclasses.replace(j_get_config("glm4-9b"), n_layers=2)
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    want = _plan(JBucketer(shapes, bucket_mb=bucket_mb))
    assert len(want) == n_buckets
    assert sum(b[2] for b in want) == 3146.0390625 * 2 ** 20
    for tree in (_meta(shapes), _meta(shapes, _port_order())):
        b = GradBucketer(tree, bucket_mb=bucket_mb)
        assert _plan(b) == want
        assert [d["tag"] for d in b.describe()] == \
            [f"g{i}" for i in range(n_buckets)]


def test_leaves_follow_jax_and_unflatten_keeps_callers_order():
    own = _port_order()
    b = GradBucketer(own, bucket_mb=0.25)
    paths = [p for p, _ in tree_paths(own)]
    assert paths == sorted(paths)
    assert paths[0] == ("embed",) and paths[-1] == ("lm_head",)
    back = b.unflatten(b.leaves(own))
    assert list(back) == list(own)
    assert list(back["layers"]) == list(own["layers"])
    for (_, x), (_, y) in zip(tree_paths(back), tree_paths(own)):
        assert x is y
    with pytest.raises(ValueError):
        b.leaves({"embed": own["embed"]})
