"""The port's payload split / merge (K7a/K7b) against the JAX reference.

The same flat payloads, made with numpy, go through the reference's
Pallas ``extract_segment`` / ``merge_segments`` (interpret mode, the
cases of tests/test_kernels.py:90-113) and through the port's plain
versions and CPU dispatch (``kernels/ops.py``): a copy, so bit for bit in
float32 and bfloat16.  The CUDA kernels are held against the plain
versions on the card, at the same shapes and at lengths and offsets one
element off the reference's blocks:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_payload_partition.py -k cuda
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import payload_partition as pp
from repro_torch.kernels import ref as tref

BLOCK = tref.BLOCK
DTYPES = ("float32", "bfloat16")
EXTRACTS = [(1, 0), (2, 1), (3, 5)]          # (n_blocks, start_block)
#: block counts of each route's segment in the split/merge round trips
SPLITS = [(1,), (2, 1), (1, 3, 2), (4, 1, 2, 3)]
TOTAL_BLOCKS = 8


def _payload(n: int, dtype: str) -> torch.Tensor:
    """x[i] = 0.5 i, as the reference's test builds it (float32, then
    cast)."""
    return torch.from_numpy(np.arange(n, dtype=np.float32) * 0.5).to(
        getattr(torch, dtype))


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    return x.view(torch.int32 if x.dtype == torch.float32
                  else torch.int16).numpy()


def _jax_bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


@pytest.fixture(scope="module")
def reference():
    """The reference's Pallas kernels in interpret mode, per case."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import payload_partition as jpp
    out = {}
    for dtype in DTYPES:
        x = jnp.asarray(_payload(TOTAL_BLOCKS * BLOCK, "float32").numpy()
                        ).astype(dtype)
        for n_blocks, start in EXTRACTS:
            out["extract", dtype, n_blocks, start] = _jax_bits(
                jpp.extract_segment(x, start, n_blocks, interpret=True))
        for sizes in SPLITS:
            xs = jnp.asarray(_payload(sum(sizes) * BLOCK, "float32").numpy()
                             ).astype(dtype)
            segs, off = [], 0
            for s in sizes:
                segs.append(jpp.extract_segment(xs, off, s, interpret=True))
                off += s
            out["merge", dtype, sizes] = _jax_bits(
                jpp.merge_segments(segs, block=BLOCK, interpret=True))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_blocks,start", EXTRACTS)
def test_extract_matches_reference(reference, dtype, n_blocks, start):
    x = _payload(TOTAL_BLOCKS * BLOCK, dtype)
    want = reference["extract", dtype, n_blocks, start]
    got = tref.extract_segment_ref(x, start, n_blocks)
    np.testing.assert_array_equal(_bits(got), want)
    before = dict(pp.launch_count)
    np.testing.assert_array_equal(
        _bits(tops.extract_segment(x, start, n_blocks)), want)
    assert pp.launch_count == before          # the CPU launches nothing
    # a copy, not a view: writing it leaves the payload alone
    got.zero_()
    assert _bits(x)[start * BLOCK + 1] != 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_split_merge_roundtrip_matches_reference(reference, dtype, sizes):
    """extract_segment per route + merge_segments == the payload, and ==
    the reference's merge of its own segments."""
    x = _payload(sum(sizes) * BLOCK, dtype)
    segs, off = [], 0
    for s in sizes:
        segs.append(tops.extract_segment(x, off, s))
        off += s
    back = tops.merge_segments(segs)
    np.testing.assert_array_equal(_bits(back), _bits(x))
    np.testing.assert_array_equal(_bits(back),
                                  reference["merge", dtype, sizes])
    np.testing.assert_array_equal(_bits(tref.merge_segments_ref(segs)),
                                  _bits(x))


def test_entry_points_keep_the_reference_asserts():
    x = _payload(4 * BLOCK, "float32")
    with pytest.raises(AssertionError):
        tops.extract_segment(x[:-1], 0, 1)          # not block-aligned
    with pytest.raises(AssertionError):
        tops.extract_segment(x, 3, 2)               # past the end
    with pytest.raises(AssertionError):
        tops.merge_segments([x, x[:-1]])


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel wrappers never compute on the CPU: they raise before any
    build or launch."""
    x = _payload(1000, "float32")
    before = dict(pp.launch_count)
    with pytest.raises(ValueError, match="CUDA"):
        pp.extract(x, 0, 10)
    with pytest.raises(ValueError, match="CUDA"):
        pp.merge([x, x])
    assert pp.launch_count == before


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_blocks,start", EXTRACTS)
def test_cuda_extract_matches_plain_version(dtype, n_blocks, start):
    """At the reference's shapes through ops.extract_segment, and at a
    start and a length one element off its blocks (unaligned words and a
    tail) through the wrapper: bit for bit."""
    x = _payload(TOTAL_BLOCKS * BLOCK + 1, dtype).cuda()
    before = pp.launch_count["extract"]
    got = tops.extract_segment(x[:-1], start, n_blocks)
    want = tref.extract_segment_ref(x[:-1], start, n_blocks)
    torch.cuda.synchronize()
    assert pp.launch_count["extract"] == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(want))
    a, n = start * BLOCK + 1, n_blocks * BLOCK - 1
    got = pp.extract(x, a, n)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got), _bits(x[a:a + n]))


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_cuda_merge_matches_plain_version(dtype, sizes):
    """One launch for all segments, block-aligned and with every segment
    one element longer (so every later one starts off alignment)."""
    x = _payload(sum(sizes) * BLOCK + len(sizes), dtype).cuda()
    for extra in (0, 1):
        segs, off = [], 0
        for s in sizes:
            segs.append(x[off:off + s * BLOCK + extra].clone())
            off += s * BLOCK + extra
        before = pp.launch_count["merge"]
        got = (tops.merge_segments(segs) if extra == 0
               else pp.merge(segs))
        torch.cuda.synchronize()
        assert pp.launch_count["merge"] == before + 1
        np.testing.assert_array_equal(_bits(got),
                                      _bits(tref.merge_segments_ref(segs)))
