"""The port's paged flash-decode (K6) against the JAX reference.

The same inputs, made with numpy from a seed, go through the JAX
``ops.paged_flash_decode`` (the Pallas kernel in interpret mode, as
tests/test_serving.py runs it) and ``ref.paged_flash_decode_ref``, and
through the port's plain version and its CPU dispatch.  Tolerances are
the reference's own: atol 3e-5 in float32, 2e-2 in bfloat16.  The
kernel's split-KV scheme (``flash_decode.split_plan`` and the log-sum-exp
merge of the splits' partials) is held against the plain version here
through a plain model of it kept in this file.  The CUDA kernel itself is
held against the plain version on the card; JAX is imported only by the
reference fixture, so those tests also run where there is no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_flash_decode.py
"""

import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _case(seed, t_rows, hq, hkv, hd, nb, bs, maxb, dtype, n_pads=1,
          kv_valid=None):
    """CPU tensors made with numpy from ``seed``: q, pools (rounded to
    ``dtype`` once), tables, kv_valid (random, or as given; the last
    n_pads rows padding)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t_rows, hq, hd), np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    tables = rng.integers(0, nb, (t_rows, maxb)).astype(np.int32)
    if kv_valid is None:
        kv_valid = rng.integers(1, maxb * bs + 1, t_rows)
    kv_valid = np.array(kv_valid, np.int32)
    if n_pads:
        kv_valid[-n_pads:] = 0
    dt = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(dt) for a in (q, kp, vp)]
            + [torch.from_numpy(tables), torch.from_numpy(kv_valid)])


# name -> (case kwargs, window)
CASES = {}
for _dt in ("float32", "bfloat16"):
    for _hq, _hkv in ((4, 2), (4, 4), (4, 1)):
        CASES[f"{_dt}-gqa{_hq}:{_hkv}"] = (
            dict(seed=0, t_rows=6, hq=_hq, hkv=_hkv, hd=64, nb=10, bs=8,
                 maxb=3, dtype=_dt), None)
    CASES[f"{_dt}-glm4"] = (dict(seed=3, t_rows=8, hq=32, hkv=2, hd=128,
                                 nb=48, bs=16, maxb=6, dtype=_dt, n_pads=2),
                            None)
CASES["float32-window8"] = (dict(seed=1, t_rows=5, hq=4, hkv=2, hd=64, nb=12,
                                 bs=8, maxb=4, dtype="float32"), 8)
CASES["float32-pads"] = (dict(seed=2, t_rows=6, hq=4, hkv=2, hd=64, nb=10,
                              bs=8, maxb=3, dtype="float32", n_pads=3), None)
for _dt in ("float32", "bfloat16"):
    # groups 8 (deepseek, qwen2), 12 (starcoder2) and 16 at hd 64
    CASES[f"{_dt}-gqa16:2"] = (dict(seed=4, t_rows=5, hq=16, hkv=2, hd=128,
                                    nb=20, bs=16, maxb=4, dtype=_dt), None)
    CASES[f"{_dt}-gqa24:2"] = (dict(seed=5, t_rows=5, hq=24, hkv=2, hd=128,
                                    nb=24, bs=8, maxb=5, dtype=_dt), None)
    CASES[f"{_dt}-gqa32:2-hd64"] = (dict(seed=6, t_rows=5, hq=32, hkv=2,
                                         hd=64, nb=20, bs=16, maxb=4,
                                         dtype=_dt), None)
    # a long table the kernel splits (split_plan: 3 splits of 256
    # positions at 132 SMs), with a window whose first position falls
    # inside a split (700 - 100 = 600 in [512, 768); 400 - 100 in
    # [256, 512)), one row that ends inside the window's reach, and a pad
    CASES[f"{_dt}-long-window100"] = (dict(seed=7, t_rows=4, hq=8, hkv=2,
                                           hd=64, nb=200, bs=16, maxb=48,
                                           dtype=_dt,
                                           kv_valid=[700, 400, 37, 0]), 100)
    # head_dim 112 (kimi-k2: d_model 7168 over 64 heads, group 8), heads
    # cut to 16 over 2; a bf16 row is 14 16-byte chunks, so a tile's
    # copies do not map onto whole rows a warp pass
    CASES[f"{_dt}-hd112"] = (dict(seed=8, t_rows=6, hq=16, hkv=2, hd=112,
                                  nb=40, bs=16, maxb=20, dtype=_dt,
                                  kv_valid=[320, 300, 17, 1, 160, 0]), None)


@pytest.fixture(scope="module")
def reference():
    """Every case's inputs and the JAX answers (Pallas kernel in interpret
    mode, and the dense-gather oracle), computed once."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    out = {}
    for name, (kw, window) in CASES.items():
        inputs = _case(**kw)
        # the same bits: bf16 values are exact in float32
        jin = [jnp.asarray(x.float().numpy()).astype(kw["dtype"])
               for x in inputs[:3]] + [jnp.asarray(x.numpy())
                                       for x in inputs[3:]]
        out[name] = (inputs, window,
                     np.asarray(jops.paged_flash_decode(*jin, window=window),
                                np.float64),
                     np.asarray(jref.paged_flash_decode_ref(*jin,
                                                            window=window),
                                np.float64))
    return out


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax(reference, name):
    inputs, window, j_kernel, j_ref = reference[name]
    got = tref.paged_flash_decode_ref(*inputs, window=window)
    assert got.dtype == inputs[0].dtype
    atol = ATOL[CASES[name][0]["dtype"]]
    np.testing.assert_allclose(_f64(got), _f64(j_ref), atol=atol, rtol=0)
    np.testing.assert_allclose(_f64(got), _f64(j_kernel), atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_dispatch_is_the_plain_version(reference, name):
    """On CPU tensors ops.paged_flash_decode runs the plain version (bit
    for bit) and launches nothing."""
    t_in, window, j_kernel, _ = reference[name]
    before = fd.launch_count
    got = tops.paged_flash_decode(*t_in, window=window)
    assert fd.launch_count == before
    want = tref.paged_flash_decode_ref(*t_in, window=window)
    assert torch.equal(got, want)
    np.testing.assert_allclose(_f64(got), _f64(j_kernel),
                               atol=ATOL[CASES[name][0]["dtype"]], rtol=0)


def test_window_bites_and_pad_rows_are_exact_zeros(reference):
    t_in, window, _, _ = reference["float32-window8"]
    windowed = tref.paged_flash_decode_ref(*t_in, window=window).numpy()
    full = tref.paged_flash_decode_ref(*t_in).numpy()
    assert not np.allclose(windowed, full)
    inputs, _, j_kernel, _ = reference["float32-pads"]
    out = tops.paged_flash_decode(*inputs).numpy()
    assert np.all(out[-3:] == 0.0) and np.all(np.asarray(j_kernel)[-3:] == 0)
    assert np.all(np.isfinite(out))


def test_kernel_takes_every_served_configs_heads():
    """Every ported config with attention (all families but ssm) has a
    head_dim the kernel was built for and a GQA group it takes, so none of
    them is refused when it serves with ``--attn-impl kernel``."""
    from repro_torch.configs import all_configs
    served = {name: cfg for name, cfg in all_configs().items()
              if not cfg.is_attention_free}
    assert len(served) == 9
    for name, cfg in served.items():
        assert cfg.head_dim_ in fd.SUPPORTED_HEAD_DIMS, name
        assert cfg.n_heads % cfg.n_kv_heads == 0, name
        assert cfg.n_heads // cfg.n_kv_heads <= fd.MAX_GROUP, name
    assert served["kimi_k2_1t_a32b"].head_dim_ == 112


def test_kernel_wrapper_rejects_cpu_tensors(reference):
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch."""
    inputs, _, _, _ = reference["float32-gqa4:2"]
    before = fd.launch_count
    with pytest.raises(ValueError, match="CUDA"):
        fd.paged_flash_decode_pool(*inputs)
    assert fd.launch_count == before


# -- the split-KV scheme ------------------------------------------------------

#: (T, Hkv, max_blocks, block_size, n_sm): the phase-4 serve shape, the
#: phase-5 long shape, the tests' shapes, edge cases, and the phase-5
#: shape at kimi-k2's Hkv of 8 (head_dim 112)
SPLIT_SHAPES = [(32, 2, 6, 16, 132), (32, 2, 256, 16, 132),
                (32, 2, 64, 16, 132), (1, 2, 256, 16, 132),
                (1, 1, 1, 16, 132), (6, 2, 3, 8, 132), (4, 2, 48, 8, 132),
                (512, 8, 256, 16, 132), (8, 16, 1000, 1, 132),
                (3, 1, 7, 5, 114), (1, 1, 4096, 16, 132),
                (2, 2, 97, 64, 132), (32, 8, 256, 16, 132)]


def _split_ranges(max_blocks, n_split, bps):
    return [(s * bps, min((s + 1) * bps, max_blocks))
            for s in range(n_split)]


def test_split_plan_reads_shapes_only():
    """The split is chosen from shapes and the SM count: kv_valid is no
    argument, so the host never waits for the device to choose it."""
    assert list(inspect.signature(fd.split_plan).parameters) == [
        "t_rows", "hkv", "max_blocks", "block_size", "n_sm"]
    for shape in SPLIT_SHAPES:
        n_split, bps = fd.split_plan(*shape)
        assert isinstance(n_split, int) and isinstance(bps, int)


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_split_plan_covers_the_table_with_nonempty_splits(shape):
    t_rows, hkv, maxb, bs, n_sm = shape
    n_split, bps = fd.split_plan(*shape)
    assert 1 <= n_split <= maxb
    ranges = _split_ranges(maxb, n_split, bps)
    assert ranges[0][0] == 0 and ranges[-1][1] == maxb
    assert all(a < b for a, b in ranges)                 # non-empty
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    if n_split > 1:     # no split but the last shorter than the minimum
        assert min(b - a for a, b in ranges[:-1]) * bs >= \
            fd.MIN_SPLIT_POSITIONS
        # and no more splits than the SMs ask for
        assert t_rows * hkv * (n_split - 1) < fd.CTAS_PER_SM * n_sm


def test_split_plan_at_the_serving_shapes():
    """The phase-4 packed step (6 blocks) runs one split, one launch; the
    256-block table fills the card with about CTAS_PER_SM CTAs an SM."""
    assert fd.split_plan(32, 2, 6, 16, 132) == (1, 6)
    n_split, bps = fd.split_plan(32, 2, 256, 16, 132)
    assert n_split > 1 and 32 * 2 * n_split >= fd.CTAS_PER_SM * 132
    assert fd.split_plan(4, 2, 48, 16, 132) == (3, 16)


def _split_model(q, k_pool, v_pool, tables, kv_valid, window, n_split):
    """Plain model of the kernel's split-KV scheme, on no path: split s
    takes logical blocks [s*bps, (s+1)*bps) and makes a partial (m, l,
    acc) over its unmasked positions with _fd_kernel's isfinite guards;
    the partials fold with the log-sum-exp rule.  Returns (out, m of every
    split [n_split, T, Hkv, group])."""
    t_rows, hq, hd = q.shape
    nb, bs, hkv, _ = k_pool.shape
    maxb = tables.shape[1]
    bps = -(-maxb // n_split)
    assert -(-maxb // bps) == n_split
    s_len = maxb * bs
    flat = (tables[:, :, None].long() * bs + torch.arange(bs)
            ).reshape(t_rows, s_len)
    k = k_pool.reshape(nb * bs, hkv, hd)[flat].double()
    v = v_pool.reshape(nb * bs, hkv, hd)[flat].double()
    qg = (q.double() / math.sqrt(hd)).reshape(t_rows, hkv, hq // hkv, hd)
    s = torch.einsum("tkgd,tskd->tkgs", qg, k)
    pos = torch.arange(s_len)[None, :]
    kvv = kv_valid[:, None].long()
    keep = pos < kvv
    if window is not None:
        keep = keep & ((kvv - 1 - pos) < window)
    ms, ls, accs = [], [], []
    for a, b in _split_ranges(maxb, n_split, bps):
        mine = keep & (pos >= a * bs) & (pos < b * bs)
        ss = torch.where(mine[:, None, None, :], s, -math.inf)
        m = ss.amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(torch.isfinite(ss), torch.exp(ss - m_safe[..., None]),
                        0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("tkgs,tskd->tkgd", p, v))
    m_all = torch.stack(ms)
    m_top = m_all.amax(dim=0)
    m_top = torch.where(torch.isfinite(m_top), m_top, 0.0)
    f = torch.where(torch.isfinite(m_all), torch.exp(m_all - m_top), 0.0)
    denom = (f * torch.stack(ls)).sum(dim=0)
    acc = (f[..., None] * torch.stack(accs)).sum(dim=0)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.reshape(t_rows, hq, hd).to(q.dtype), m_all


@pytest.mark.parametrize("name", ["float32-long-window100", "float32-pads",
                                  "float32-window8", "float32-gqa24:2",
                                  "float32-hd112"])
def test_split_merge_model_matches_plain_version_at_every_split(name):
    """At every n_split from 1 to max_blocks (each one split_plan could
    give), the split partials merged by log-sum-exp equal the plain
    version within the float32 atol; padding rows are exact zeros; and
    the long case does have empty splits (past kv_valid, and before the
    window)."""
    kw, window = CASES[name]
    t_in = _case(**kw)
    want = tref.paged_flash_decode_ref(*t_in, window=window)
    pads = kw.get("n_pads", 1)
    maxb = kw["maxb"]
    n_empty = 0
    for n_split in range(1, maxb + 1):
        bps = -(-maxb // n_split)
        if -(-maxb // bps) != n_split:   # no bps gives this many splits
            continue
        got, m_all = _split_model(*t_in, window, n_split)
        np.testing.assert_allclose(_f64(got), _f64(want), atol=ATOL["float32"],
                                   rtol=0, err_msg=f"n_split={n_split}")
        assert torch.all(got[-pads:] == 0), n_split
        n_empty += int((~torch.isfinite(m_all[:, :-pads])).sum())
    if name.startswith("float32-long"):
        assert n_empty > 0


def test_split_model_empty_splits_before_the_window():
    """Rows 0 and 1 of the long case start their window inside a split:
    the splits wholly before it and wholly past kv_valid are empty, the
    rest are not."""
    kw, window = CASES["float32-long-window100"]
    t_in = _case(**kw)
    n_split, bps = fd.split_plan(kw["t_rows"], kw["hkv"], kw["maxb"],
                                 kw["bs"], 132)
    _, m_all = _split_model(*t_in, window, n_split)
    span = bps * kw["bs"]
    for t, kvv in enumerate(kw["kv_valid"]):
        lo = max(0, kvv - window)
        for s in range(n_split):
            live = s * span < kvv and (s + 1) * span > lo
            assert bool(torch.isfinite(m_all[s, t]).all()) == live, (t, s)
    assert (kw["kv_valid"][0] - window) % span != 0     # inside a split


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_version(name):
    kw, window = CASES[name]
    t_in = [x.cuda() for x in _case(**kw)]
    before = fd.launch_count
    got = tops.paged_flash_decode(*t_in, window=window)
    torch.cuda.synchronize()
    assert fd.launch_count == before + 1
    want = tref.paged_flash_decode_ref(*t_in, window=window)
    np.testing.assert_allclose(_f64(got.cpu()), _f64(want.cpu()),
                               atol=ATOL[CASES[name][0]["dtype"]], rtol=0)
    pads = CASES[name][0].get("n_pads", 1)
    assert torch.all(got[-pads:] == 0)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("name", ["float32-long-window100",
                                  "bfloat16-long-window100",
                                  "bfloat16-gqa24:2", "float32-gqa16:2",
                                  "bfloat16-hd112", "float32-hd112"])
def test_cuda_kernel_at_forced_splits(name, monkeypatch):
    """The kernel with split_plan forced to 1, 2, 3, ... splits (and the
    merge launch that n_split > 1 adds) equals the plain version."""
    kw, window = CASES[name]
    t_in = [x.cuda() for x in _case(**kw)]
    want = tref.paged_flash_decode_ref(*t_in, window=window)
    maxb = kw["maxb"]
    pads = kw.get("n_pads", 1)
    for bps in sorted({max(1, maxb // n) for n in (1, 2, 3, 5, maxb)}):
        n_split = -(-maxb // bps)
        monkeypatch.setattr(fd, "split_plan",
                            lambda *a, _p=(n_split, bps): _p)
        before = fd.launch_count
        got = tops.paged_flash_decode(*t_in, window=window)
        torch.cuda.synchronize()
        assert fd.launch_count == before + 1
        np.testing.assert_allclose(_f64(got.cpu()), _f64(want.cpu()),
                                   atol=ATOL[kw["dtype"]], rtol=0,
                                   err_msg=f"n_split={n_split}")
        assert torch.all(got[-pads:] == 0)
