"""The port's layers against the JAX reference on reduced glm4-9b (f32).

Inputs are made with numpy from a seed; the parameters are the
reference's ``init_params`` tree carried across by ``convert.py``.  The
math is the same in float32 but the matmuls sum in another order, so the
tolerance is atol 1e-5, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import init_params as j_init_params
from repro.models import single_device_ctx as j_ctx
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import layers as TL
from repro_torch.models import single_device_ctx as t_ctx

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("glm4-9b").reduced()
    tcfg = t_get_config("glm4-9b").reduced()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    layer0 = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"])
    return jcfg, tcfg, layer0, params_from_reference(layer0)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_rms_norm(setup):
    jcfg, _, layer0, tlayer0 = setup
    x = _rng(0).standard_normal((2, 5, jcfg.d_model), np.float32)
    w = 1.0 + 0.1 * _rng(1).standard_normal(jcfg.d_model).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("pos_shape", ["S", "BS"])
def test_apply_rope(pos_shape):
    rng = _rng(2)
    x = rng.standard_normal((3, 7, 4, 64), np.float32)
    pos = (rng.integers(0, 90, 7) if pos_shape == "S"
           else rng.integers(0, 90, (3, 7))).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


# name -> chunked_attention kwargs (numpy values); chunk 8 over 20 keys
# exercises several chunks and the ATTN_CHUNK-style padding
ATTN_CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, window=5),
    "kv_valid_vector": dict(causal=True,
                            q_offset=np.array([3, 9, 0], np.int32),
                            kv_valid=np.array([7, 13, 4], np.int32)),
    "q_offset_scalar": dict(causal=True, q_offset=6, kv_valid=10),
    "all_masked_row": dict(causal=True,
                           q_offset=np.array([2, 5, 8], np.int32),
                           kv_valid=np.array([0, 6, 12], np.int32)),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_chunked_attention(name):
    rng = _rng(3)
    q = rng.standard_normal((3, 4, 4, 64), np.float32)
    k = rng.standard_normal((3, 20, 2, 64), np.float32)
    v = rng.standard_normal((3, 20, 2, 64), np.float32)
    kw = ATTN_CASES[name]

    def conv(val, fn):
        return fn(val) if isinstance(val, np.ndarray) else val

    j_out = JL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=8,
        **{a: conv(b, jnp.asarray) for a, b in kw.items()})
    t_out = TL.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        chunk=8, **{a: conv(b, torch.from_numpy) for a, b in kw.items()})
    _close(t_out, j_out)
    if name == "all_masked_row":
        assert torch.all(t_out[0] == 0.0)


def test_mlp_block(setup):
    jcfg, _, layer0, tlayer0 = setup
    x = 0.5 * _rng(4).standard_normal((2, 3, jcfg.d_model), np.float32)
    _close(TL.mlp_block(tlayer0["mlp"], torch.from_numpy(x), t_ctx()),
           JL.mlp_block(jax.tree.map(jnp.asarray, layer0["mlp"]),
                        jnp.asarray(x), j_ctx()))


@pytest.mark.parametrize("cache_pos", ["scalar", "vector", "none"])
def test_attention_block(setup, cache_pos):
    """No-cache branch and dense-cache branch (scalar and per-slot
    positions): output and the returned cache."""
    jcfg, tcfg, layer0, tlayer0 = setup
    rng = _rng(5)
    b, s_cache = 3, 24
    s = 1 if cache_pos == "vector" else 2
    x = 0.5 * rng.standard_normal((b, s, jcfg.d_model), np.float32)
    ck = rng.standard_normal((b, s_cache, 2, 64), np.float32)
    cv = rng.standard_normal((b, s_cache, 2, 64), np.float32)
    pos = np.array([4, 11, 0], np.int32) if cache_pos == "vector" else 9
    positions = (pos[:, None] if cache_pos == "vector"
                 else pos + np.arange(s)).astype(np.int32)
    jap = jax.tree.map(jnp.asarray, layer0["attn"])
    if cache_pos == "none":
        j_out, _ = JL.attention_block(jap, jnp.asarray(x), jcfg, j_ctx())
        t_out, _ = TL.attention_block(tlayer0["attn"], torch.from_numpy(x),
                                      tcfg, t_ctx())
        _close(t_out, j_out)
        return
    jpos = jnp.asarray(pos)
    j_out, (jk, jv) = JL.attention_block(
        jap, jnp.asarray(x), jcfg, j_ctx(), positions=jnp.asarray(positions),
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_pos=jpos)
    t_out, (tk, tv) = TL.attention_block(
        tlayer0["attn"], torch.from_numpy(x), tcfg, t_ctx(),
        positions=torch.from_numpy(positions),
        kv_cache=(torch.from_numpy(ck), torch.from_numpy(cv)),
        cache_pos=torch.as_tensor(pos))
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_paged_attention_block(setup, impl):
    """Both port impls against the reference impl of the JAX block:
    output, and the pools after the scatter (padding rows write
    nothing)."""
    jcfg, tcfg, layer0, tlayer0 = setup
    rng = _rng(6)
    t_rows, nb, bs, maxb = 6, 10, 8, 3
    x = 0.5 * rng.standard_normal((t_rows, 1, jcfg.d_model), np.float32)
    kp = rng.standard_normal((nb, bs, 2, 64), np.float32)
    vp = rng.standard_normal((nb, bs, 2, 64), np.float32)
    # rows 0-2 one request (blocks 4,7,1), rows 3-4 another, row 5 padding
    tables = np.array([[4, 7, 1]] * 3 + [[2, 9, 5]] * 2 + [[4, 7, 1]],
                      np.int32)
    positions = np.array([9, 10, 11, 0, 1, 0], np.int32)
    kv_valid = np.array([10, 11, 12, 1, 2, 0], np.int32)
    j_out, (jk, jv) = JL.paged_attention_block(
        jax.tree.map(jnp.asarray, layer0["attn"]), jnp.asarray(x), jcfg,
        j_ctx(), positions=jnp.asarray(positions),
        kv_valid=jnp.asarray(kv_valid),
        pools=(jnp.asarray(kp), jnp.asarray(vp)),
        block_tables=jnp.asarray(tables), impl="reference")
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_out, (rk, rv) = TL.paged_attention_block(
        tlayer0["attn"], torch.from_numpy(x), tcfg, t_ctx(),
        positions=torch.from_numpy(positions),
        kv_valid=torch.from_numpy(kv_valid), pools=(tkp, tvp),
        block_tables=torch.from_numpy(tables), impl=impl)
    assert rk is tkp and rv is tvp          # the pool is updated in place
    _close(t_out, j_out)
    _close(rk, jk)
    _close(rv, jv)
    assert torch.all(t_out[-1] == 0.0)      # padding row: zero attention
    # only the five real rows' slots changed
    changed = np.argwhere(np.any(rk.numpy() != kp, axis=(2, 3)))
    assert len(changed) == 5
