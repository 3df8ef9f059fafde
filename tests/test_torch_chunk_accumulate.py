"""The port's ring-step accumulate (K1) against the JAX reference.

The same operands, made with numpy from a seed, go through the JAX
``chunk_accumulate_2d`` (the Pallas kernel in interpret mode, on the
reference's ``_pad_2d`` tiles) and ``ops.accumulate``, and through the
port's plain version and its CPU dispatch.  The function is one fp32 add
and one rounding, so every comparison is bit for bit, in float32 and
bfloat16, at lengths that do and do not fill the reference's tiles.  The
CUDA kernel is held against the plain version on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_chunk_accumulate.py -k cuda
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_accumulate as ca
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = ("float32", "bfloat16")
# (shape, whether it fills whole [8k, 128] tiles)
SHAPES = [(1,), (7,), (1000,), (1024,), (3, 5, 129), (8, 128), (4099,)]


def _operands(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * 8
    b = rng.standard_normal(shape).astype(np.float32)
    dt = getattr(torch, dtype)
    return torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[x.dtype]
    return x.contiguous().view(view).numpy()


def _jax_bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


@pytest.fixture(scope="module")
def reference():
    """The JAX answers per (dtype, shape): the Pallas kernel on padded
    tiles (interpret mode) and ops.accumulate."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import chunk_accumulate as jca
    from repro.kernels import ops as jops
    out = {}
    for dtype in DTYPES:
        for shape in SHAPES:
            a, b = _operands(len(shape) + shape[-1], shape, dtype)
            ja = jnp.asarray(a.float().numpy()).astype(dtype)
            jb = jnp.asarray(b.float().numpy()).astype(dtype)
            tiles = jca.chunk_accumulate_2d(jops._pad_2d(ja), jops._pad_2d(jb),
                                            interpret=True)
            kernel = tiles.reshape(-1)[:a.numel()].reshape(shape)
            out[(dtype, shape)] = (a, b, _jax_bits(kernel),
                                   _jax_bits(jops.accumulate(ja, jb)))
    return out


CASES = [(d, s) for d in DTYPES for s in SHAPES]
IDS = [f"{d}-{'x'.join(map(str, s))}" for d, s in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_matches_jax_bit_for_bit(reference, case):
    a, b, j_kernel, j_ops = reference[case]
    got = tref.chunk_accumulate_ref(a, b)
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(_bits(got), j_kernel)
    np.testing.assert_array_equal(_bits(got), j_ops)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_dispatch_is_the_plain_version(reference, case):
    """ops.accumulate on CPU tensors runs the plain version and launches
    nothing; the ring closure is the same function."""
    a, b, j_kernel, _ = reference[case]
    before = dict(ca.launch_count)
    got = tops.accumulate(a, b)
    assert ca.launch_count == before
    np.testing.assert_array_equal(_bits(got), j_kernel)
    np.testing.assert_array_equal(_bits(tops.ring_accumulate_fn()(a, b)),
                                  j_kernel)


def test_plain_version_takes_strided_operands():
    """The ring hands the accumulate column slices of a sub-chunk view."""
    a, b = _operands(3, (6, 40), "bfloat16")
    got = tops.accumulate(a[:, 8:24], b[:, 8:24])
    want = tref.chunk_accumulate_ref(a[:, 8:24].contiguous(),
                                     b[:, 8:24].contiguous())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_passes_the_cotangent_to_both_operands(dtype):
    a, b = _operands(5, (3, 70), dtype)
    a.requires_grad_(True)
    b.requires_grad_(True)
    g = _operands(6, (3, 70), dtype)[0]
    tops.accumulate(a, b).backward(g)
    assert torch.equal(a.grad, g) and torch.equal(b.grad, g)


def test_operands_must_agree():
    """One dtype, or the bf16_pack decode's float32 + bfloat16 (the only
    mixed call); anything else, or two shapes, raises."""
    a, b = _operands(1, (16,), "float32")
    with pytest.raises(ValueError, match="differ"):
        tops.accumulate(a.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="differ"):
        tops.accumulate(a, b.to(torch.float16))
    with pytest.raises(ValueError, match="differ"):
        tops.accumulate(a, b[:8])
    assert tops.accumulate(a, b.to(torch.bfloat16)).dtype == torch.float32


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch."""
    a, b = _operands(1, (16,), "float32")
    before = dict(ca.launch_count)
    with pytest.raises(ValueError, match="CUDA"):
        ca.chunk_accumulate(a, b)
    assert ca.launch_count == before


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("dtype", DTYPES + ("float16",))
@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 7])
def test_cuda_kernel_matches_plain_version(dtype, n):
    """Bit for bit, with 16-byte aligned operands (vector path) and with
    operands one element off alignment (scalar path)."""
    a, b = _operands(n % 97, (n + 1,), "float32")
    dt = getattr(torch, dtype)
    a, b = a.to(dt).cuda(), b.to(dt).cuda()
    for off in (0, 1):
        x, y = a[off:off + n], b[off:off + n]
        before = ca.launch_count[dt, dt]
        got = tops.accumulate(x, y)
        torch.cuda.synchronize()
        assert ca.launch_count[dt, dt] == before + 1
        want = tref.chunk_accumulate_ref(x, y)
        np.testing.assert_array_equal(_bits(got), _bits(want))
