"""The port's payload split / merge (K7a/K7b) against the JAX reference.

The same flat payloads, made with numpy, go through the reference's
Pallas ``extract_segment`` / ``merge_segments`` (interpret mode, the
cases of tests/test_kernels.py:90-113, merges of 9 and 17 segments, and
splits with empty segments between others) and through the port's plain
versions and CPU dispatch (``kernels/ops.py``): a copy, so bit for bit in
float32 and bfloat16.  How a merge is cut into launches of at most 8
segments is plain Python, tested here too.  The CUDA kernels are held
against the plain versions on the card, at the same shapes and at
lengths and offsets one element off the reference's blocks, in float32,
bfloat16 and uint8:

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
#: block counts of each route's segment in the split/merge round trips:
#: the reference test's, merges of 9 and 17 segments (two and three
#: launches on the card), and empty segments between others
SPLITS = [(1,), (2, 1), (1, 3, 2), (4, 1, 2, 3), (1,) * 9,
          (1, 2) * 8 + (1,), (2, 0, 1), (1, 0, 0, 3, 0, 1)]
TOTAL_BLOCKS = 8
#: the card's cases also copy bytes
CUDA_DTYPES = DTYPES + ("uint8",)


def _payload(n: int, dtype: str) -> torch.Tensor:
    """x[i] = 0.5 i, as the reference's test builds it (float32, then
    cast); uint8 counts i mod 251."""
    if dtype == "uint8":
        return torch.from_numpy((np.arange(n) % 251).astype(np.uint8))
    return torch.from_numpy(np.arange(n, dtype=np.float32) * 0.5).to(
        getattr(torch, dtype))


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.uint8: torch.uint8}[x.dtype]).numpy()


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
            # an empty segment would give the Pallas kernel an empty grid,
            # which interpret mode refuses: the reference merges the others
            segs, off = [], 0
            for s in sizes:
                if s:
                    segs.append(jpp.extract_segment(xs, off, s,
                                                    interpret=True))
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


@pytest.mark.parametrize("n_segments", [1, 8, 9, 16, 17])
@pytest.mark.parametrize("empty", [(), (0,), (0, 3, 4)],
                         ids=["none", "first", "three"])
def test_launch_groups_cover_every_element_once(n_segments, empty):
    """A merge's launches: ceil(nonzero / 8) of them, at most 8 nonzero
    segments each, in order, every output element written by one row."""
    lengths = [0 if j in empty else 3 + (7 * j) % 5
               for j in range(n_segments)]
    groups = pp.launch_groups(lengths)
    nonzero = [j for j, n in enumerate(lengths) if n]
    assert len(groups) == -(-len(nonzero) // pp.MAX_SEGMENTS)
    assert all(1 <= len(g) <= pp.MAX_SEGMENTS for g in groups)
    rows = [r for g in groups for r in g]
    assert [j for j, _, _ in rows] == nonzero
    covered = np.zeros(sum(lengths), dtype=np.int64)
    for j, off, n in rows:
        assert n == lengths[j] and off == sum(lengths[:j])
        covered[off:off + n] += 1
    np.testing.assert_array_equal(covered, 1)


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
@pytest.mark.parametrize("dtype", CUDA_DTYPES)
@pytest.mark.parametrize("n_blocks,start", EXTRACTS)
def test_cuda_extract_matches_plain_version(dtype, n_blocks, start):
    """At the reference's shapes through ops.extract_segment, and at a
    start and a length one element off its blocks (unaligned elements and
    a tail) through the wrapper: bit for bit, one launch each."""
    x = _payload(TOTAL_BLOCKS * BLOCK + 1, dtype).cuda()
    want = tref.extract_segment_ref(x[:-1], start, n_blocks)
    before = pp.launch_count["extract"]
    got = tops.extract_segment(x[:-1], start, n_blocks)
    a, n = start * BLOCK + 1, n_blocks * BLOCK - 1
    off = pp.extract(x, a, n)
    torch.cuda.synchronize()
    assert pp.launch_count["extract"] == before + 2
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(off), _bits(x[a:a + n]))


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("dtype", CUDA_DTYPES)
@pytest.mark.parametrize("sizes", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_cuda_merge_matches_plain_version(dtype, sizes):
    """ceil(nonzero segments / 8) launches, block-aligned and with every
    segment one element longer (so every later one starts off alignment,
    and the empty ones hold one element)."""
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
        nonzero = sum(1 for s in segs if s.numel())
        assert pp.launch_count["merge"] == before + -(-nonzero // 8)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(tref.merge_segments_ref(segs)))
