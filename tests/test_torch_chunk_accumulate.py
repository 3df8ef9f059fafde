"""The port's ring-step accumulate (K1) against the JAX reference.

The same operands, made with numpy from a seed, go through the JAX
``chunk_accumulate_2d`` (the Pallas kernel in interpret mode, on the
reference's ``_pad_2d`` tiles) and ``ops.accumulate``, and through the
port's plain version and its CPU dispatch.  The function is one fp32 add
and one rounding, so every comparison is bit for bit, in float32 and
bfloat16, at lengths that do and do not fill the reference's tiles.  The
list form ``ops.accumulate_many`` (one launch a ring step on the card) is
held against the JAX kernel pair by pair, for tables of 1, 2, 3 and 8
segments of unequal lengths, aligned and one element off.  The CUDA
kernels are held against the plain version on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_chunk_accumulate.py -k cuda
"""

import collections

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_accumulate as ca
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = ("float32", "bfloat16", "float16")
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


# segment tables of the list form: indices into SHAPES, 1, 2, 3 and 8
# segments of unequal lengths (a length may repeat)
TABLES = [(6,), (2, 1), (4, 0, 3), (1, 2, 0, 5, 6, 3, 4, 1)]
TABLE_IDS = [f"{len(t)}seg" for t in TABLES]


def _off_by_one(x: torch.Tensor) -> torch.Tensor:
    """x's values in a view that starts one element into a larger buffer
    (a sub-chunk sliced at an odd offset)."""
    big = torch.empty(x.numel() + 1, dtype=x.dtype)
    big[1:] = x.reshape(-1)
    return big[1:].view(x.shape)


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "off1"])
@pytest.mark.parametrize("table", TABLES, ids=TABLE_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_list_form_matches_jax_pair_by_pair(reference, dtype, table, off):
    """accumulate_many over a ring step's sub-chunks equals the JAX kernel
    on each pair, bit for bit; its results are views of one buffer laid
    end to end, and it launches nothing on the CPU; the ring closure's
    ``many`` is the same function."""
    cases = [reference[(dtype, SHAPES[k])] for k in table]
    move = _off_by_one if off else (lambda x: x)
    as_ = [move(a) for a, _, _, _ in cases]
    bs = [move(b) for _, b, _, _ in cases]
    before = dict(ca.launch_count)
    for got in (tops.accumulate_many(as_, bs),
                tops.ring_accumulate_fn().many(as_, bs)):
        assert len(got) == len(table)
        base = got[0]._base
        off_elems = 0
        for g, a, (_, _, j_kernel, _) in zip(got, as_, cases):
            assert g.shape == a.shape and g.dtype == a.dtype
            assert g._base is base and g.storage_offset() == off_elems
            off_elems += g.numel()
            np.testing.assert_array_equal(_bits(g), j_kernel)
        assert base.numel() == off_elems
    assert ca.launch_count == before


def test_list_form_refuses_what_the_kernel_cannot_take():
    """More than 8 segments (a ring step has at most
    routing.MAX_STAGED_SUBSTEPS sub-chunks), unequal lists, mismatched
    pairs, operands that need a gradient: all raise, on any device."""
    from repro_torch.core.routing import MAX_STAGED_SUBSTEPS
    assert tops.MAX_SEGMENTS == ca.MAX_SEGMENTS == MAX_STAGED_SUBSTEPS
    a, b = _operands(1, (16,), "bfloat16")
    assert len(tops.accumulate_many([a] * 8, [b] * 8)) == 8
    for as_, bs in (([a] * 9, [b] * 9), ([], []), ([a, a], [b])):
        with pytest.raises(ValueError, match="1 to 8"):
            tops.accumulate_many(as_, bs)
    with pytest.raises(ValueError, match="differ"):
        tops.accumulate_many([a, a], [b, b[:8]])
    with pytest.raises(ValueError, match="gradient"):
        tops.accumulate_many([a.clone().requires_grad_(True)], [b])


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch."""
    a, b = _operands(1, (16,), "float32")
    before = dict(ca.launch_count)
    with pytest.raises(ValueError, match="CUDA"):
        ca.chunk_accumulate(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ca.chunk_accumulate_segments([a, a], [b, b])
    with pytest.raises(ValueError, match="9 segments"):
        ca.chunk_accumulate_segments([a] * 9, [b] * 9)
    assert ca.launch_count == before


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("dtype", DTYPES)
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


#: segment tables on the card: lengths around the units (8 elements of
#: bf16/f16 b, 4 of f32), the ring's sub-chunk lengths and a long one that
#: takes the long body
CUDA_TABLES = [(1,), (1000, 7), (131072, 131072), (4096, 1, 8191),
               (9, 8, 7, 16, 15, 17, 131071, 1 << 20), ((1 << 23) + 3,)]
#: per segment, how many elements its operands sit past 16-byte
#: alignment: all aligned (vector path), all one off (scalar path), every
#: other one off (both in one launch)
CUDA_OFFSETS = {"aligned": lambda j: 0, "off1": lambda j: 1,
                "mixed": lambda j: j % 2}


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("offsets", sorted(CUDA_OFFSETS))
@pytest.mark.parametrize("lengths", CUDA_TABLES,
                         ids=[f"{len(t)}seg-{max(t)}" for t in CUDA_TABLES])
@pytest.mark.parametrize("pair", [("float32", "float32"),
                                  ("bfloat16", "bfloat16"),
                                  ("float16", "float16"),
                                  ("float32", "bfloat16")])
def test_cuda_segments_match_plain_version(pair, lengths, offsets):
    """One launch over the whole table, bit for bit with the plain version
    pair by pair; a segment takes the vector path exactly when its
    operands are 16-byte aligned."""
    da, db = (getattr(torch, d) for d in pair)
    shift = CUDA_OFFSETS[offsets]
    as_, bs = [], []
    for j, n in enumerate(lengths):
        a, b = _operands(n % 89 + j, (n + 1,), "float32")
        k = shift(j)
        as_.append(a.to(da).cuda()[k:k + n])
        bs.append(b.to(db).cuda()[k:k + n])
    launches = ca.launch_count[da, db]
    paths = collections.Counter(ca.segment_paths)
    got = ca.chunk_accumulate_segments(as_, bs)
    torch.cuda.synchronize()
    assert ca.launch_count[da, db] == launches + 1
    # the output buffer's segments start wherever the earlier lengths end
    want_vec = sum(a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
                   and g.data_ptr() % 16 == 0
                   for a, b, g in zip(as_, bs, got))
    assert ca.segment_paths - paths == collections.Counter(
        {"vector": want_vec, "scalar": len(lengths) - want_vec})
    for g, a, b in zip(got, as_, bs):
        np.testing.assert_array_equal(_bits(g),
                                      _bits(tref.chunk_accumulate_ref(a, b)))
