"""The precondition of K2's hardware fp8 conversion, proved on the CPU.

K2 (``kernels/csrc/codec.cu``) converts its quotients ``q = x / scale``
with the card's saturating ``cvt.rn.satfinite``, where the reference
converts without saturation (``jnp`` / ml_dtypes: out of range gives NaN,
or inf for e5m2).  The two give the same byte for every ``|q|`` below the
format's overflow midpoint, the point halfway between its largest finite
value and the next step up (464 for e4m3, 61440 for e5m2): at or above it
the non-saturating cast leaves the finite range.

Within a group ``|x| <= amax`` and division rounds monotonically, so every
quotient K2 forms is at most ``q(amax) = fl(amax / fl(max(amax, 1e-30) *
fl(1 / FP8_MAX)))`` in float32 round-to-nearest.  The tests evaluate
q(amax) exhaustively:

- every finite positive bfloat16 amax;
- every float32 mantissa at exponent 0, at the exponents where the 1e-30
  clamp acts (it takes over inside [2^-100, 2^-99)) and at the top
  exponent (up to FLT_MAX).  Between -99 and 127, q(amax) equals its
  value at exponent 0: scaling amax by 2^k scales the product and the
  scale exactly while both stay normal, and leaves the quotient alone.
  Below -101 the clamped scale is one constant and q grows with amax, so
  exponent -101 bounds them.

numpy's float32 multiply and divide round to nearest, as ``__fmul_rn``
and ``__fdiv_rn`` do on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

FMTS = ("fp8_e4m3", "fp8_e5m2")
#: halfway between the largest finite value and the next step up
MIDPOINT = {"fp8_e4m3": 464.0, "fp8_e5m2": 61440.0}
#: float32 exponents swept over all 2^23 mantissas: 1, the clamp's
#: neighbourhood (1e-30 lies in [2^-100, 2^-99)) and the top
EXPONENTS = (0, -101, -100, -99, 127)


def _quotient(amax: np.ndarray, fmt: str) -> np.ndarray:
    """q(amax) as K2 forms it, in float32 round-to-nearest."""
    inv = np.float32(1.0 / tref.FP8_MAX[fmt])
    scale = np.maximum(amax, np.float32(tref._SCALE_TINY)) * inv
    return amax / scale


def _bf16_amaxes() -> np.ndarray:
    """Every finite positive bfloat16, as float32."""
    bits = np.arange(1, 0x7F80, dtype=np.uint32) << 16
    return bits.view(np.float32)


def _mantissas(exponent: int) -> np.ndarray:
    """Every float32 with this unbiased exponent, positive."""
    bits = (np.arange(1 << 23, dtype=np.uint32)
            | np.uint32((exponent + 127) << 23))
    return bits.view(np.float32)


def _top_quotients(fmt: str) -> np.ndarray:
    """The distinct q(amax) at or above half the format's max, over both
    exhaustive sets."""
    tops = []
    for amax in [_bf16_amaxes()] + [_mantissas(e) for e in EXPONENTS]:
        q = _quotient(amax, fmt)
        tops.append(np.unique(q[q >= tref.FP8_MAX[fmt] / 2]))
    return np.unique(np.concatenate(tops))


@pytest.mark.parametrize("fmt", FMTS)
def test_bf16_amax_quotients_stay_below_the_overflow_midpoint(fmt):
    with np.errstate(all="raise"):
        q = _quotient(_bf16_amaxes(), fmt)
    assert np.isfinite(q).all()
    assert q.max() < MIDPOINT[fmt]
    # the clamp makes small groups' quotients small, not large
    assert q.min() >= 0


@pytest.mark.parametrize("exponent", EXPONENTS)
@pytest.mark.parametrize("fmt", FMTS)
def test_float32_amax_quotients_stay_below_the_overflow_midpoint(fmt,
                                                                 exponent):
    amax = _mantissas(exponent)
    with np.errstate(all="raise"):
        q = _quotient(amax, fmt)
    assert np.isfinite(q).all()
    assert q.max() < MIDPOINT[fmt]
    if exponent == 0:       # no clamp: q(amax) sits at FP8_MAX, within ulps
        assert np.abs(q / np.float32(tref.FP8_MAX[fmt]) - 1).max() < 1e-6


def test_power_of_two_scaling_leaves_the_quotient_alone():
    """The argument that lets four exponents stand for all: q(2^k amax) ==
    q(amax) wherever the clamp does not act and the scale stays normal,
    checked on a sample of mantissas at every such exponent."""
    rng = np.random.default_rng(0)
    base = _mantissas(0)[rng.integers(0, 1 << 23, 4096)]
    for fmt in FMTS:
        want = _quotient(base, fmt)
        for k in range(-99, 128):
            got = _quotient(np.ldexp(base, k), fmt)
            np.testing.assert_array_equal(got, want, err_msg=f"2^{k} {fmt}")


@pytest.mark.parametrize("fmt", FMTS)
def test_saturating_and_reference_casts_agree_at_k2s_largest_quotients(fmt):
    """At every q(amax) of the exhaustive sets (and their negatives), torch's
    cast, the reference's jnp cast and the plain version give one byte,
    and that byte is finite."""
    jnp = pytest.importorskip("jax.numpy")
    q = _top_quotients(fmt)
    assert q.size and q.max() < MIDPOINT[fmt]
    q = np.concatenate([q, -q])
    t = torch.from_numpy(q).to(tref.WIRE_DTYPE[fmt])
    j = np.asarray(jnp.asarray(q).astype(
        {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}[fmt]))
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                  j.view(np.uint8))
    assert torch.isfinite(t.float()).all()
    # a group's abs-max element lands on the format's largest value
    assert np.abs(t.float().numpy()).max() == tref.FP8_MAX[fmt]
