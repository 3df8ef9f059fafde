"""The port's wire codecs (K2-K5) and the mixed-dtype K1 against the JAX
reference.

The same inputs, made with numpy from a seed, go through the reference's
``kernels/ops.py`` wire functions (the Pallas kernels in interpret mode,
on its ``_pad_2d`` tiles) and the port's plain versions
(``kernels/ref.py``) and CPU dispatch (``kernels/ops.py``).  Everything is
compared bit for bit: the fp8 bytes and scales of K2, the outputs of K4
and K3 (one fused multiply-add), the bf16 pack of K5, and K1 on a float32
chunk with a bfloat16 one.  Groups holding inf or NaN decode to NaN at
the same places as the reference's.  The CUDA kernels are held against the
plain versions on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_codec.py -k cuda
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_accumulate as ca
from repro_torch.kernels import codec as tcodec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

LENGTHS = (1, 127, 128, 1000, 4099)
DTYPES = ("float32", "bfloat16")
FMTS = ("fp8_e4m3", "fp8_e5m2")
CASES = [(n, d, f) for n in LENGTHS for d in DTYPES for f in FMTS]
IDS = [f"{f}-{d}-{n}" for n, d, f in CASES]


def _payload(n, dtype, seed, special=False):
    """Random values whose 128-element groups span 10 decades; with
    ``special``, group 0 holds a NaN, group 2 an inf and the last group a
    -inf (where the length has them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    groups = -(-n // 128)
    x *= np.repeat(np.exp(rng.uniform(-12, 12, groups)), 128)[:n].astype(
        np.float32)
    if special:
        x[min(5, n - 1)] = np.nan
        if n > 2 * 128:
            x[2 * 128 + 7] = np.inf
            x[n - 1] = -np.inf
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, t.float().numpy()


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(x)
    return x.view({4: np.int32, 2: np.int16, 1: np.uint8}[x.dtype.itemsize])


def _tbits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return x.view(torch.uint8).numpy()
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()]).numpy()


def _jax_wire(xf, dtype, fmt, b):
    """The reference's encode (bytes, scales), decode and decode-
    accumulate of the flat payload ``xf`` (float32 numpy, cast to
    ``dtype``), trimmed of its tile padding."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    n = xf.size
    x = jnp.asarray(xf).astype(dtype)
    vals, scales = jops.wire_encode(x, codec_name=fmt)
    dec = jops.wire_decode(vals, scales, codec_name=fmt, shape=(n,),
                           dtype=x.dtype)
    acc = jops.wire_decode_accumulate(vals, scales,
                                      jnp.asarray(b).astype(dtype),
                                      codec_name=fmt)
    return (np.asarray(vals).view(np.uint8).reshape(-1)[:n],
            np.asarray(scales).reshape(-1)[:-(-n // 128)],
            np.asarray(dec.astype(jnp.float32)),
            np.asarray(acc.astype(jnp.float32)))


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    out = {}
    for n, dtype, fmt in CASES:
        x, xf = _payload(n, dtype, n + len(fmt))
        b, bf = _payload(n, dtype, n + 7)
        out[(n, dtype, fmt)] = (x, b, _jax_wire(xf, dtype, fmt, bf))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp8_plain_versions_match_reference_bit_for_bit(reference, case):
    n, dtype, fmt = case
    x, b, (j_vals, j_scales, j_dec, j_acc) = reference[case]
    vals, scales = tref.fp8_encode_ref(x, fmt=fmt)
    assert vals.dtype == tref.WIRE_DTYPE[fmt] and vals.shape == (n,)
    assert scales.dtype == torch.float32 and scales.shape == (-(-n // 128),)
    np.testing.assert_array_equal(_tbits(vals), j_vals)
    np.testing.assert_array_equal(_tbits(scales), _bits(j_scales))
    dec = tref.fp8_decode_ref(vals, scales, out_dtype=x.dtype)
    np.testing.assert_array_equal(_tbits(dec.float()), _bits(j_dec))
    acc = tref.fp8_decode_accumulate_ref(vals, scales, b)
    assert acc.dtype == b.dtype
    np.testing.assert_array_equal(_tbits(acc.float()), _bits(j_acc))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_wire_ops_are_the_plain_versions(reference, case):
    """ops.wire_* on CPU tensors run the plain versions and launch
    nothing."""
    n, dtype, fmt = case
    x, b, (j_vals, _, j_dec, j_acc) = reference[case]
    before = dict(tcodec.launch_count)
    vals, scales = tops.wire_encode(x, codec_name=fmt)
    np.testing.assert_array_equal(_tbits(vals), j_vals)
    dec = tops.wire_decode(vals, scales, codec_name=fmt, shape=(n,),
                           dtype=x.dtype)
    np.testing.assert_array_equal(_tbits(dec.float()), _bits(j_dec))
    acc = tops.wire_decode_accumulate(vals, scales, b, codec_name=fmt)
    np.testing.assert_array_equal(_tbits(acc.float()), _bits(j_acc))
    rt = tops.wire_roundtrip(x.reshape(1, n), codec_name=fmt)
    assert rt.shape == (1, n) and torch.equal(rt.reshape(-1), dec)
    assert tcodec.launch_count == before


def test_fused_decode_accumulate_is_one_rounding():
    """A separate multiply and add in float32 differs from the reference
    on these inputs; the plain version's single rounding does not."""
    x, xf = _payload(4099, "float32", 3)
    b, bf = _payload(4099, "float32", 4)
    _, _, _, j_acc = _jax_wire(xf, "float32", "fp8_e4m3", bf)
    vals, scales = tref.fp8_encode_ref(x)
    two = (vals.float() * scales.repeat_interleave(128)[:4099]) + b
    assert (_tbits(two) != _bits(j_acc)).any()
    np.testing.assert_array_equal(
        _tbits(tref.fp8_decode_accumulate_ref(vals, scales, b)),
        _bits(j_acc))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_nonfinite_groups_decode_to_nan_like_the_reference(fmt, dtype):
    """A group holding NaN or inf scales to NaN or inf and decodes to NaN
    everywhere, as the reference's does (the NaN's sign in the fp8 byte
    is the platform's, so NaNs compare by place); finite groups stay bit
    for bit."""
    n = 1000
    x, xf = _payload(n, dtype, 11, special=True)
    b, bf = _payload(n, dtype, 12)
    j_vals, j_scales, j_dec, j_acc = _jax_wire(xf, dtype, fmt, bf)
    vals, scales = tref.fp8_encode_ref(x, fmt=fmt)
    dec = tref.fp8_decode_ref(vals, scales, out_dtype=x.dtype).float()
    acc = tref.fp8_decode_accumulate_ref(vals, scales, b).float()
    bad = np.zeros(n, bool)
    for g in (0, 2, (n - 1) // 128):
        bad[g * 128:(g + 1) * 128] = True
    for got, want in ((dec.numpy(), j_dec), (acc.numpy(), j_acc)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[bad]).all()
        np.testing.assert_array_equal(_bits(got[~bad]), _bits(want[~bad]))
    finite = np.repeat(~np.isnan(j_scales) & np.isfinite(j_scales), 128)[:n]
    np.testing.assert_array_equal(_tbits(vals)[finite], j_vals[finite])
    nan_byte = tref.FP8_NAN_BYTE[fmt]
    assert set(_tbits(vals)[np.isnan(vals.float().numpy())]) <= {nan_byte}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_bf16_pack_matches_reference(dtype, n):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, xf = _payload(n, dtype, n)
    j_vals, _ = jops.wire_encode(jnp.asarray(xf).astype(dtype),
                                 codec_name="bf16_pack")
    want = _bits(np.asarray(j_vals)).reshape(-1)[:n]
    np.testing.assert_array_equal(_tbits(tref.bf16_pack_ref(x)), want)
    vals, scales = tops.wire_encode(x, codec_name="bf16_pack")
    assert scales is None
    np.testing.assert_array_equal(_tbits(vals), want)
    if dtype == "bfloat16":              # the pack is exact for bf16 data
        assert torch.equal(tops.wire_roundtrip(x, codec_name="bf16_pack"),
                           x)


@pytest.mark.parametrize("n", LENGTHS)
def test_mixed_accumulate_matches_reference(n):
    """K1 on a float32 local chunk and a received bf16 one (the bf16_pack
    decode-accumulate): out float32, one rounding."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    mine, mf = _payload(n, "float32", n + 1)
    x, xf = _payload(n, "bfloat16", n + 2)
    j_vals, _ = jops.wire_encode(jnp.asarray(xf).astype("bfloat16"),
                                 codec_name="bf16_pack")
    want = np.asarray(jops.wire_decode_accumulate(
        j_vals, None, jnp.asarray(mf), codec_name="bf16_pack"))
    before = dict(ca.launch_count)
    got = tops.wire_decode_accumulate(x, None, mine, codec_name="bf16_pack")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    np.testing.assert_array_equal(
        _tbits(tops.accumulate(mine, x)), _bits(want))
    assert ca.launch_count == before


def test_mixed_accumulate_backward_gives_each_operand_its_dtype():
    a, _ = _payload(300, "float32", 1)
    b, _ = _payload(300, "bfloat16", 2)
    a.requires_grad_(True)
    b.requires_grad_(True)
    g = torch.ones(300)
    tops.accumulate(a, b).backward(g)
    assert a.grad.dtype == torch.float32 and b.grad.dtype == torch.bfloat16
    assert torch.equal(a.grad, g) and torch.equal(b.grad.float(), g)


def test_other_mixed_dtypes_are_refused():
    a, _ = _payload(16, "bfloat16", 1)
    b, _ = _payload(16, "float32", 2)
    with pytest.raises(ValueError, match="differ"):
        tops.accumulate(a, b)


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel wrappers never compute on the CPU: they raise before any
    build or launch."""
    x, _ = _payload(300, "float32", 1)
    vals, scales = tref.fp8_encode_ref(x)
    before = dict(tcodec.launch_count)
    for call in (lambda: tcodec.fp8_encode(x),
                 lambda: tcodec.fp8_decode(vals, scales, "fp8_e4m3"),
                 lambda: tcodec.fp8_decode_accumulate(vals, scales, x,
                                                      "fp8_e4m3"),
                 lambda: tcodec.bf16_pack(x),
                 lambda: ca.chunk_accumulate(x, x.bfloat16())):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert tcodec.launch_count == before


# -- on the card ---------------------------------------------------------------

def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bit for bit where the values are numbers; NaN at the same places."""
    g, w = got.detach().cpu(), want.detach().cpu()
    assert g.dtype == w.dtype and g.shape == w.shape
    if g.dtype in (torch.float32, torch.bfloat16):
        gn, wn = torch.isnan(g.float()), torch.isnan(w.float())
        assert torch.equal(gn, wn)
        g, w = g[~gn], w[~wn]
    np.testing.assert_array_equal(_tbits(g), _tbits(w))


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernels have no CPU mode")
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 127, 1000, (1 << 20) + 7])
def test_cuda_codec_kernels_match_plain_versions(n, dtype, fmt):
    """K2, K4, K3 and K5 on the card against their plain versions on the
    card, with aligned inputs (vector paths) and inputs one element off
    alignment (scalar paths), NaN and inf groups included."""
    x, _ = _payload(n + 1, dtype, n % 89, special=True)
    b, _ = _payload(n + 1, dtype, n % 83)
    x, b = x.cuda(), b.cuda()
    for off in (0, 1):
        xs, bs = x[off:off + n], b[off:off + n]
        vals, scales = tcodec.fp8_encode(xs, fmt)
        r_vals, r_scales = tref.fp8_encode_ref(xs, fmt=fmt)
        _same(vals, r_vals)
        _same(scales, r_scales)
        _same(tcodec.fp8_decode(vals, scales, fmt, xs.dtype),
              tref.fp8_decode_ref(vals, scales, out_dtype=xs.dtype))
        _same(tcodec.fp8_decode_accumulate(vals, scales, bs, fmt),
              tref.fp8_decode_accumulate_ref(vals, scales, bs))
        _same(tcodec.bf16_pack(xs), tref.bf16_pack_ref(xs))
        if dtype == "float32":
            p = tref.bf16_pack_ref(bs)
            _same(tops.accumulate(xs, p), tref.chunk_accumulate_ref(xs, p))
    torch.cuda.synchronize()
