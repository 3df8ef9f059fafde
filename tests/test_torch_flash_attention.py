"""Self-attention of the train step and the cache-free prefill: kernel K9
(``kernels/flash_attention.py``, ``kernels/csrc/flash_attention.cu``) and
its plain version, ``kernels/ref.py::chunked_attention``.

``kernels/ops.py::attention`` hands CPU and ``meta`` operands to the
plain version and CUDA ones to K9: bfloat16 operands to its bf16 route,
float32 ones to its float32 route.  On the CPU: the op is the plain
version bit for bit, forward and gradients; ``_self_attention``'s
cache-free branch and ``mla_core`` call it, the decode paths do not;
every refusal raises before a launch; the module imports without
building the kernel.  On the card K9 is held against the plain version
in float32 on the same operands (no JAX here, so the card cases run
without the conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_flash_attention.py -k cuda
"""

import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as k9
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.tp import ParallelCtx
from repro_torch.runtime import spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 34

#: (batch, length, q heads, kv heads, d_qk, d_v, causal, window, v a
#: split view as MLA's); the CPU cases, small
CPU_CASES = {
    "gqa_causal": (2, 37, 4, 2, 16, 16, True, None, False),
    "mha_full": (1, 29, 3, 3, 8, 8, False, None, False),
    "window": (1, 40, 4, 1, 16, 16, True, 7, False),
    "mla_view": (1, 33, 2, 2, 24, 16, True, None, True),
}


def _operands(case, dtype, device="cpu", seed=SEED):
    b, s, hq, hkv, d_qk, d_v, _, _, view = case
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)
    q, k = draw(b, s, hq, d_qk), draw(b, s, hkv, d_qk)
    # MLA's value is the second part of [k_nope | v] (layers.mla_core)
    v = draw(b, s, hkv, 128 + d_v)[..., 128:] if view else draw(b, s, hkv,
                                                                 d_v)
    return q, k, v, draw(b, s, hq, d_v)


def _grads(fn, q, k, v, do):
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*xs)
    out.backward(do)
    return [out.detach()] + [x.grad for x in xs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_op_is_the_plain_version_on_cpu(name, dtype):
    """CPU operands take ``chunked_attention`` itself: forward and the
    three gradients bit for bit, at GQA, full attention, a window and
    MLA's split value view; K9 never launches."""
    case = CPU_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, do = _operands(case, dtype)
    before = kernels.launch_counts()["k9"]
    got = _grads(lambda *x: ops.attention(*x, causal=causal, window=window,
                                          scale=0.3), q, k, v, do)
    want = _grads(lambda *x: L.chunked_attention(
        *x, causal=causal, window=window, scale=0.3), q, k, v, do)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)
    assert kernels.launch_counts()["k9"] == before


def test_counters_by_path():
    """``attn.plain`` adds the query rows x heads of each CPU call while
    a profiler records; ``meta`` calls count nowhere, and nothing is
    counted outside a profiler."""
    q, k, v, _ = _operands(CPU_CASES["gqa_causal"], torch.float32)
    spans.counters()
    ops.attention(q, k, v, causal=True)
    assert spans.counters() == {}
    meta = [x.to("meta") for x in (q, k, v)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.counters()
        ops.attention(q, k, v, causal=True)
        out = ops.attention(*meta, causal=True)
        got = spans.counters()
    assert out.device.type == "meta" and out.shape == q.shape
    assert got == {"attn.plain": q.shape[0] * q.shape[1] * q.shape[2]}


def _cache_free_calls(monkeypatch):
    seen = []
    real = ops.attention

    def counting(q, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, *args, **kw)
    monkeypatch.setattr(ops, "attention", counting)
    return seen


def test_call_sites(monkeypatch):
    """``_self_attention`` without a cache and ``mla_core`` attend
    through the op, each inside its span; a decode over a cache and
    cross-attention stay on ``chunked_attention``."""
    seen = _cache_free_calls(monkeypatch)
    ctx = ParallelCtx()
    cfg = get_config("glm4-9b").reduced()
    gen = torch.Generator().manual_seed(SEED)
    p = L.init_attention(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 6, cfg.d_model, generator=gen)
    L.attention_block(p, x, cfg, ctx)
    assert seen == [(2, 6, cfg.n_heads, cfg.head_dim_)]
    cache = tuple(torch.zeros(2, 16, cfg.n_kv_heads, cfg.head_dim_)
                  for _ in range(2))
    L.attention_block(p, x[:, :1], cfg, ctx, kv_cache=cache, cache_pos=3)
    L.attention_block(p, x, cfg, ctx, causal=False, xattn_kv=cache)
    assert len(seen) == 1
    # the value width ``wo`` reads, as the published config sets it
    kimi = dataclasses.replace(get_config("kimi-k2-instruct").reduced(),
                               head_dim=128)
    pm = L.init_attention(gen, kimi, torch.float32, "cpu")
    L.attention_block(pm, torch.randn(1, 5, kimi.d_model, generator=gen),
                      kimi, ctx)
    m = kimi.mla
    assert seen[1] == (1, 5, kimi.n_heads,
                       m.qk_nope_head_dim + m.qk_rope_head_dim)


def _meta(b=1, s=64, hq=4, hkv=2, d_qk=128, d_v=128, dtype=torch.bfloat16):
    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return t(b, s, hq, d_qk), t(b, s, hkv, d_qk), t(b, s, hkv, d_v)


def _refusals():
    q, k, v = _meta()
    wide = torch.empty(1, 64, 2, 256, dtype=torch.bfloat16, device="meta")
    return {
        "float16": (_meta(dtype=torch.float16), {}, "bfloat16"),
        "float32": ((q.float(), k, v), {}, "all three alike"),
        "width_96": (_meta(d_qk=96, d_v=96), {}, "head widths"),
        "v_width_192": (_meta(d_qk=192, d_v=192), {}, "head widths"),
        "heads": (_meta(hq=6, hkv=4), {}, "query heads"),
        "two_lengths": ((q, k[:, :32], v[:, :32]), {}, "self-attention"),
        "v_heads": ((q, k, v[:, :, :1]), {}, "self-attention"),
        "rank": ((q[0], k[0], v[0]), {}, "dims"),
        "head_stride": ((q, k, wide[..., ::2]), {}, "stride"),
        "window_0": ((q, k, v), {"window": 0}, "window"),
        "on_meta": ((q, k, v), {}, "not CUDA"),
        "on_cpu": (tuple(torch.zeros(x.shape, dtype=x.dtype)
                         for x in (q, k, v)), {}, "not CUDA"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_refusals_raise_before_a_launch(name):
    """Every operand K9 does not take raises, with a message, before any
    launch, and before the kernel is built or loaded."""
    (q, k, v), kw, words = _refusals()[name]
    before, libs = dict(k9.launch_count), dict(k9._libs)
    for call in (k9.attention, k9.forward):
        args = {"causal": True, "window": kw.get("window")}
        if call is k9.forward:
            args["scale"] = 0.1
        with pytest.raises(ValueError, match=words):
            call(q, k, v, **args)
    assert dict(k9.launch_count) == before and k9._libs == libs


def test_widths_split_into_power_of_two_parts():
    """Each width K9 takes is a whole number of the MMA's 16-deep steps
    and 8-wide column blocks, so no part of a head is padded (192 is
    twelve steps, 112 seven), and ``check`` admits exactly the pairs of
    ``WIDTHS`` among the widths a step divides."""
    assert all(d % 16 == 0 for pair in k9.WIDTHS for d in pair)
    for d_qk in range(16, 257, 16):
        for d_v in range(16, 257, 16):
            words = ("not CUDA" if (d_qk, d_v) in k9.WIDTHS
                     else "head widths")
            with pytest.raises(ValueError, match=words):
                k9.check(*_meta(d_qk=d_qk, d_v=d_v))


def test_each_width_pair_and_route_is_its_own_library():
    """One build of the source a width pair and route, each under its own
    defines and so its own library (a first call compiles 3 kernels, not
    24); the other kernels' libraries keep the names they had."""
    from repro_torch.kernels import _nvcc, adamw
    builds = k9.variants()
    assert len(builds) == 2 * len(k9.WIDTHS)
    assert {d for _, defines in builds for d in defines} >= {
        "-DK9_DQK=192", "-DK9_DV=128", "-DK9_F32=0", "-DK9_F32=1"}
    paths = {_nvcc.library_path(src, defines) for src, defines in builds}
    assert len(paths) == len(builds)
    assert _nvcc.library_path(adamw.SOURCE) == _nvcc.library_path(
        adamw.SOURCE, ())
    assert _nvcc.library_path(k9.SOURCE) not in paths


def test_module_imports_without_a_card():
    """The kernel module, its dispatch and ``launch_counts`` import and
    run without a card or ``nvcc``: the kernel is built and loaded at the
    first launch."""
    code = ("from repro_torch import kernels\n"
            "from repro_torch.kernels import flash_attention, ops\n"
            "assert flash_attention._libs == {}\n"
            "assert kernels.launch_counts()['k9'] == 0\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: the train cells' two head shapes, at their length and a ragged one,
#: whisper's full attention at 64, a window that cuts, and kimi-k2's 112
CUDA_CASES = {
    "mixtral_4096": (1, 4096, 32, 8, 128, 128, True, 4096, False),
    "mixtral_1000": (1, 1000, 32, 8, 128, 128, True, None, False),
    "kimi_mla_4096": (1, 4096, 64, 64, 192, 128, True, None, True),
    "kimi_mla_1000": (1, 1000, 64, 64, 192, 128, True, None, True),
    "full_64": (2, 300, 16, 16, 64, 64, False, None, False),
    "window_100": (1, 1000, 8, 2, 128, 128, True, 100, False),
    "full_window_100": (1, 1000, 8, 2, 128, 128, False, 100, False),
    "hd_112": (1, 500, 8, 1, 112, 112, True, None, False),
}
#: the float32 output against the plain version's on the same bf16
#: operands: the same float32 arithmetic summed in another order over up
#: to 4096 keys, exp2 for exp, and P's product through its hi + lo bf16
#: halves (2^-16 of each element left out); the card read 1e-6 to 2.4e-6
#: of the largest output, so 2e-5 leaves eightfold room
O32_REL = 2e-5
#: a bf16 result: its own rounding (at most half an ulp, 2^-8 of the
#: value) plus the float32 differences before it (as O32_REL, with room
#: for the longer sums of a gradient)
BF16_ROUND = 2 ** -8
BF16_SLACK = 1e-4
#: the float32 route against the plain version in float32, each result
#: relative to its largest element: both are float32 arithmetic on the
#: same operands (K9's through three bf16 planes, 24 bits, the plane
#: products below float32's rounding left out), summed in other orders
#: over up to 4096 keys or queries, with exp2 for exp
F32_REL = 2e-5
#: the float32 route's cases: the train cells' head shapes at a ragged
#: length, whisper's full attention at 64 and a window that cuts
F32_CASES = ("mixtral_1000", "kimi_mla_1000", "full_64", "window_100")


def _cuda():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close_bf16(got, want, what):
    err = (got.float() - want).abs()
    room = BF16_ROUND * want.abs() + BF16_SLACK * want.abs().max()
    worst = float((err - room).max())
    assert worst <= 0, f"{what}: {worst} past the bound"


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain_version(name):
    """K9's forward (float32 and bf16 outputs) and its three gradients
    against the plain version in float32 on the same bf16 operands; the
    bf16 output is the float32 one rounded; one forward and two backward
    launches."""
    _cuda()
    case = CUDA_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, do = _operands(case, torch.bfloat16, "cuda")
    scale = 1 / math.sqrt(q.shape[3])
    before = dict(k9.launch_count)
    o, o32, lse = k9.forward(q, k, v, causal=causal, window=window,
                             scale=scale)
    dq, dk, dv = k9.backward(q, k, v, o32, lse, do, causal=causal,
                             window=window, scale=scale)
    torch.cuda.synchronize()
    assert {n: k9.launch_count[n] - before.get(n, 0)
            for n in ("forward", "dq", "dkdv")} == {
        "forward": 1, "dq": 1, "dkdv": 1}
    want = _grads(lambda *x: L.chunked_attention(
        *x, causal=causal, window=window, scale=scale),
        *(x.float() for x in (q, k, v, do)))
    assert torch.equal(o, o32.to(torch.bfloat16))
    rel = float((o32 - want[0]).abs().max() / want[0].abs().max())
    assert rel <= O32_REL, f"{name}: float32 output {rel}"
    _close_bf16(o, want[0], f"{name} out")
    for got, ref, what in zip((dq, dk, dv), want[1:], ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        _close_bf16(got, ref, f"{name} {what}")


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("name", F32_CASES)
def test_cuda_float32_route_matches_plain_version(name):
    """Float32 operands: K9's output and three gradients, all float32,
    against the plain version's on the same operands; the output is the
    forward's float32 one; one forward and two backward launches beside
    the splits of q, k, v (forward) and q, k, v, dO (backward)."""
    _cuda()
    case = CUDA_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, do = _operands(case, torch.float32, "cuda")
    scale = 1 / math.sqrt(q.shape[3])
    before = dict(k9.launch_count)
    o, o32, lse = k9.forward(q, k, v, causal=causal, window=window,
                             scale=scale)
    grads = k9.backward(q, k, v, o32, lse, do, causal=causal,
                        window=window, scale=scale)
    torch.cuda.synchronize()
    assert {n: k9.launch_count[n] - before.get(n, 0)
            for n in ("forward", "dq", "dkdv", "split")} == {
        "forward": 1, "dq": 1, "dkdv": 1, "split": 7}
    assert o is o32
    want = _grads(lambda *x: L.chunked_attention(
        *x, causal=causal, window=window, scale=scale), q, k, v, do)
    for got, ref, what in zip((o, *grads), want, ("out", "dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == torch.float32
        rel = float((got - ref).abs().max() / ref.abs().max())
        assert rel <= F32_REL, f"{name} {what}: {rel}"


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
def test_cuda_backward_bits_repeat():
    """No float atomics: two backward passes give the same bits."""
    q, k, v, do = _operands(CUDA_CASES["mixtral_1000"], torch.bfloat16,
                            "cuda")
    o, o32, lse = k9.forward(q, k, v, causal=True, window=None, scale=0.08)
    first = k9.backward(q, k, v, o32, lse, do, causal=True, window=None,
                        scale=0.08)
    second = k9.backward(q, k, v, o32, lse, do, causal=True, window=None,
                         scale=0.08)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
def test_cuda_dispatch_counts_and_refusal():
    """CUDA operands take K9, bf16 and float32 alike
    (``launch_counts()["k9"]`` counts its forward and two backward
    launches, and the float32 route's 7 splits; ``attn.kernel`` the rows,
    no ``attn.plain``); float16 raises before a launch."""
    _cuda()
    case = (1, 256, 8, 2, 128, 128, True, None, False)
    rows = 256 * 8
    q, k, v, do = _operands(case, torch.bfloat16, "cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.counters()
        before = kernels.launch_counts()["k9"]
        _grads(lambda *x: ops.attention(*x, causal=True), q, k, v, do)
        assert kernels.launch_counts()["k9"] == before + 3
        _grads(lambda *x: ops.attention(*x, causal=True),
               *(x.float() for x in (q, k, v, do)))
        assert kernels.launch_counts()["k9"] == before + 13
        got = spans.counters()
    assert got == {"attn.kernel": 2 * rows}
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ops.attention(*(x.half() for x in (q, k, v)), causal=True)
    assert kernels.launch_counts()["k9"] == before + 13


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
def test_cuda_train_step_attention_takes_the_kernel():
    """A bf16 attention block's forward and backward on the card (the
    train step's cache-free branch) launch K9 three times."""
    _cuda()
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = L.init_attention(gen, cfg, torch.bfloat16, "cuda")
    x = torch.randn(2, 100, cfg.d_model, generator=gen, device="cuda")
    before = kernels.launch_counts()["k9"]
    out, _ = L.attention_block(p, x.bfloat16().requires_grad_(), cfg,
                               ParallelCtx())
    out.float().sum().backward()
    assert kernels.launch_counts()["k9"] == before + 3
