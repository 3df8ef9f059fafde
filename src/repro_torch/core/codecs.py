# Copied from src/repro/core/codecs.py; only the imports are renamed.
"""Per-path payload codecs: wire-byte compression for secondary paths.

FlexLink offloads 2-22% of collective traffic onto PCIe/NIC rails that are
5-20x slower than NVLink — exactly the links where shrinking wire bytes buys
the most effective bandwidth.  A :class:`PayloadCodec` describes one wire
encoding: its wire-byte ratio and processing throughput (what the
PathTimingModel prices) and its data-plane identity (what the Pallas
encode/decode kernels in ``repro.kernels`` implement).

The contract (DESIGN.md §12):

* ``off`` is the default everywhere — no codec attached means the plan,
  its signature, the Stage-1 trajectory and the tuning-cache entries are
  byte-identical to an uncompressed build.
* Codecs only ever attach to NON-primary path segments.  The NVLink
  primary path always carries raw bytes (the paper's lossless contract),
  and ``parse_compress`` has no scope that can name it.
* Lossy codecs (fp8) are opt-in per launch (``--compress secondary=fp8``)
  and the tuner still *chooses* per (link, op, bucket) whether the codec
  pays: the pricing adds a fixed setup latency plus a throughput term, so
  tiny messages never compress even when the flag is on.

Wire-byte accounting is quoted against the fp32 payloads the pricing layer
sees (gradients and fp32 activations).  One f32 scale rides per
``SCALE_CHUNK`` encoded values, which is what the ratio below includes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

#: encoded values per f32 scale — one scale per 128-lane kernel row, so the
#: decode side can fuse scale application into the staged-reduce accumulate.
SCALE_CHUNK = 128

#: route-class scopes a ``--compress`` spec may name.  "secondary" expands
#: to every non-primary class; the primary path is not addressable.
_SECONDARY_SCOPES = ("staged", "ortho")

#: spec aliases accepted on the CLI.
ALIASES = {
    "fp8": "fp8_e4m3",
    "bf16": "bf16_pack",
}


@dataclasses.dataclass(frozen=True)
class PayloadCodec:
    """One wire encoding, with the constants the pricing layer needs.

    ``wire_ratio`` is wire bytes / logical bytes for fp32 payloads
    (including per-chunk scale overhead).  ``throughput_GBps`` is the
    combined encode+decode processing rate and ``setup_s`` a fixed per-op
    kernel-launch cost — together they make compression a *priced* choice
    rather than a flag: tiny messages lose on setup, fast links lose on
    the throughput term, and only bandwidth-bound transfers on slow links
    win.  ``lossless`` means bit-exact for payloads the codec accepts
    natively (bf16_pack is a passthrough for bf16 data; it truncates
    mantissa bits of wider dtypes, which is why it is still opt-in).
    """

    name: str
    wire_ratio: float
    throughput_GBps: float
    setup_s: float
    lossless: bool

    def lossless_for(self, payload_dtype) -> bool:
        """Bit-exact for payloads of ``payload_dtype``?

        The static ``lossless`` flag says the codec CAN be exact (bf16_pack
        is, for bf16 data); whether it IS depends on the payload: packing
        fp32 gradients to bf16 truncates 16 mantissa bits.  This per-dtype
        form is what gates error feedback (``lossy_codec_name``,
        train/bucketer.py) — the static flag alone would skip residual
        compensation exactly where the truncation happens.
        """
        if not self.lossless:
            return False
        exact = _EXACT_DTYPES.get(self.name)
        if exact is None:
            return True
        return str(payload_dtype) in exact

    def wire_bytes(self, logical_bytes: float) -> float:
        return logical_bytes * self.wire_ratio

    def codec_time_s(self, logical_bytes: float) -> float:
        """Processing cost of pushing ``logical_bytes`` through the codec."""
        if self.throughput_GBps <= 0:
            return 0.0
        return self.setup_s + logical_bytes / (self.throughput_GBps * 1e9)


#: fp8 wire bytes per fp32 logical element: 1 value byte + 4/SCALE_CHUNK
#: scale bytes, over the 4 logical bytes.
_FP8_RATIO = (1.0 + 4.0 / SCALE_CHUNK) / 4.0

#: payload dtypes a LOSSLESS codec is actually bit-exact for; any other
#: dtype gets truncated on the wire and must be treated as lossy by the
#: error-feedback gate.  Codecs absent here (``off``) are exact for every
#: dtype.
_EXACT_DTYPES = {"bf16_pack": ("bfloat16",)}

_REGISTRY: Dict[str, PayloadCodec] = {}


def register_codec(codec: PayloadCodec) -> PayloadCodec:
    prev = _REGISTRY.get(codec.name)
    if prev is not None and prev != codec:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


OFF = register_codec(PayloadCodec(
    name="off", wire_ratio=1.0, throughput_GBps=0.0, setup_s=0.0,
    lossless=True))
BF16_PACK = register_codec(PayloadCodec(
    name="bf16_pack", wire_ratio=0.5, throughput_GBps=900.0,
    setup_s=20e-6, lossless=True))
FP8_E4M3 = register_codec(PayloadCodec(
    name="fp8_e4m3", wire_ratio=_FP8_RATIO, throughput_GBps=600.0,
    setup_s=20e-6, lossless=False))
FP8_E5M2 = register_codec(PayloadCodec(
    name="fp8_e5m2", wire_ratio=_FP8_RATIO, throughput_GBps=600.0,
    setup_s=20e-6, lossless=False))


def get_codec(name: str) -> PayloadCodec:
    key = ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown codec {name!r} (have {sorted(_REGISTRY)})")
    return _REGISTRY[key]


def parse_compress(spec: str) -> Dict[str, str]:
    """``--compress`` spec -> {route_class: codec_name}.

    ``"secondary=fp8"`` maps both non-primary route classes to fp8_e4m3;
    individual classes can be named (``"staged=bf16,ortho=fp8"``).  The
    empty spec returns an empty dict — the byte-identical default.
    """
    out: Dict[str, str] = {}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad --compress entry {part!r}: expected scope=codec")
        scope, _, name = part.partition("=")
        scope, name = scope.strip(), name.strip()
        codec = get_codec(name)          # validates + resolves aliases
        scopes = _SECONDARY_SCOPES if scope == "secondary" else (scope,)
        for sc in scopes:
            if sc not in _SECONDARY_SCOPES:
                raise ValueError(
                    f"bad --compress scope {scope!r}: the primary path "
                    f"never compresses; use one of "
                    f"{('secondary',) + _SECONDARY_SCOPES}")
            if codec.name == "off":
                out.pop(sc, None)
            else:
                out[sc] = codec.name
    return out


def canonical_spec(spec: str) -> str:
    """Normalized, sorted form of a compress spec — the string folded into
    TuningProfile keys so compressed and uncompressed runs never share
    Stage-1 entries (shares tuned against codec pricing are not valid for
    raw wire bytes, and vice versa)."""
    resolved = parse_compress(spec)
    return ",".join(f"{k}={v}" for k, v in sorted(resolved.items()))


def lossy_codec_name(spec: str, payload_dtype: str = "float32") -> str:
    """The configured codec that actually LOSES bits for ``payload_dtype``
    payloads, or "" — the error-feedback gate for gradient-sync slots
    (train/bucketer.py).  Truly exact wire encodings need no residuals,
    but exactness is per dtype: bf16_pack is lossless for bf16 data and a
    16-bit mantissa truncation for fp32 gradients, so the gate consults
    :meth:`PayloadCodec.lossless_for` rather than the static flag.  The
    fp32 default matches the dtype the pricing layer quotes (module
    docstring) and the common gradient-sync payload; callers whose whole
    tree is genuinely bf16 can pass ``payload_dtype="bfloat16"`` to skip
    the residual state."""
    for name in parse_compress(spec).values():
        if not get_codec(name).lossless_for(payload_dtype):
            return name
    return ""


def codecs_for_pricing(spec: str,
                       route_of: Mapping[str, str],
                       primary: str) -> Dict[str, Optional[PayloadCodec]]:
    """Candidate codec per link name: {link: PayloadCodec} for every
    non-primary link whose route class the spec names.  The primary link
    is structurally excluded."""
    resolved = parse_compress(spec)
    out: Dict[str, Optional[PayloadCodec]] = {}
    for link, cls in route_of.items():
        if link == primary:
            continue
        name = resolved.get(cls)
        if name:
            out[link] = get_codec(name)
    return out
