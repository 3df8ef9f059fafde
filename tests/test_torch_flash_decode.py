"""The port's paged flash-decode (K6) against the JAX reference.

The same inputs, made with numpy from a seed, go through the JAX
``ops.paged_flash_decode`` (the Pallas kernel in interpret mode, as
tests/test_serving.py runs it) and ``ref.paged_flash_decode_ref``, and
through the port's plain version and its CPU dispatch.  Tolerances are
the reference's own: atol 3e-5 in float32, 2e-2 in bfloat16.  The CUDA
kernel itself is held against the plain version on the card; JAX is
imported only by the reference fixture, so that test also runs where
there is no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_flash_decode.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _case(seed, t_rows, hq, hkv, hd, nb, bs, maxb, dtype, n_pads=1):
    """CPU tensors made with numpy from ``seed``: q, pools (rounded to
    ``dtype`` once), tables, kv_valid (the last n_pads rows padding)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t_rows, hq, hd), np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    tables = rng.integers(0, nb, (t_rows, maxb)).astype(np.int32)
    kv_valid = rng.integers(1, maxb * bs + 1, t_rows).astype(np.int32)
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


def test_kernel_wrapper_rejects_cpu_tensors(reference):
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch."""
    inputs, _, _, _ = reference["float32-gqa4:2"]
    before = fd.launch_count
    with pytest.raises(ValueError, match="CUDA"):
        fd.paged_flash_decode_pool(*inputs)
    assert fd.launch_count == before


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
