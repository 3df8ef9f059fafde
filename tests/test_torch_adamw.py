"""The optimizer's two passes: kernel K8 and its plain version.

``optim/adamw.py`` hands the whole tree to ``kernels/ops.py``: the
global norm, then the update, in place.  CPU and ``meta`` leaves take the
plain slice loop in ``kernels/ref.py``; CUDA leaves take K8
(``kernels/csrc/adamw.cu``).  On the CPU the plain version is held
against the reference's ``apply_updates`` (src/repro/optim/adamw.py)
one optimizer step at a time, and the dispatch, the refusals and the
counters are checked with the device check mocked.  The port-vs-JAX
checks of whole training steps are in tests/test_torch_train.py.  The
kernel is held against the plain version on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_adamw.py -k cuda
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as k8
from repro_torch.kernels import ops, ref
from repro_torch.optim import adamw
from repro_torch.runtime import spans


SHAPES = {"w": (7, 45), "stack": (2, 3, 50), "norm": (45,), "b": (1,)}


def _tree(seed, dtype, grad_scale):
    rng = np.random.default_rng(seed)

    def draw(shape, s):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32)).to(dtype)
    params = {k: draw(s, 0.5) for k, s in SHAPES.items()}
    grads = [{k: draw(s, grad_scale) for k, s in SHAPES.items()}
             for _ in range(2)]
    return params, grads


#: the plain version against the reference, after two steps of
#: SHAPES' tree (measured: gnorm 1.2e-7, moments 2.9e-6, float32 params
#: 7.2e-8, bf16 params equal).  The reference sums the squares in one
#: pass where the port sums slice by slice, which moves the clip factor by
#: an ulp or so, and XLA chooses its own fused multiply-adds: float32
#: noise, compounded over a leaf of one element by the second step's
#: moment update.  A missing decay moves float32 params by 1e-3, a missing
#: bias correction bf16 params by several ulps.
REF_GNORM_REL = 1e-6
REF_MOMENT_REL = 1e-5
REF_PARAM_REL = 1e-6
#: bf16 params: at most one ulp apart (a float32 difference that flips the
#: final rounding), on at most this share of elements
REF_BF16_SHARE = 0.01


def _ulp(x, bits):
    """One ulp at each element's magnitude of a type of ``bits``
    significant bits (8: bf16, 24: float32), as float32."""
    return torch.exp2((torch.frexp(x.float())[1] - bits).float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0], ids=["unclipped",
                                                         "clipped"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
@pytest.mark.parametrize("slice_len", [ref.UPDATE_SLICE, 64],
                         ids=["one_slice", "many_slices"])
def test_plain_version_matches_the_reference(monkeypatch, dtype,
                                             grad_scale, weight_decay,
                                             slice_len):
    """Two steps of the optimizer on CPU leaves against the reference's
    ``apply_updates`` on the same inputs: the norm, both moments and the
    params, in bf16 and float32, decay on (2-dim leaves) and off (1-dim
    leaves, or a zero decay), the clip engaged and not, with leaves of one
    slice and of several."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from repro.optim import adamw as j_adamw

    def to_jax(tree):
        return {k: jnp.asarray(
            x.float().numpy().astype(ml_dtypes.bfloat16)
            if x.dtype == torch.bfloat16 else x.numpy().copy())
            for k, x in tree.items()}
    monkeypatch.setattr(ref, "UPDATE_SLICE", slice_len)
    hyper = dict(lr=1e-2, warmup_steps=1, grad_clip=1.0,
                 weight_decay=weight_decay)
    cfg, j_cfg = adamw.AdamWConfig(**hyper), j_adamw.AdamWConfig(**hyper)
    j_step = jax.jit(j_adamw.apply_updates, static_argnums=3)
    params, grads = _tree(3, dtype, grad_scale)
    j_params = to_jax(params)
    state, j_state = adamw.init_state(params), j_adamw.init_state(j_params)
    for g in grads:
        params, state, met = adamw.apply_updates(params, g, state, cfg)
        j_params, j_state, j_met = j_step(j_params, to_jax(g), j_state,
                                          j_cfg)
        want = float(j_met["grad_norm"])
        assert abs(float(met["grad_norm"]) / want - 1) <= REF_GNORM_REL
        if grad_scale > 1:
            assert want > cfg.grad_clip
    assert int(state.step) == int(j_state.step) == 2
    for k in SHAPES:
        assert params[k].dtype == dtype
        for got, want in ((state.mu[k], j_state.mu[k]),
                          (state.nu[k], j_state.nu[k])):
            want = torch.from_numpy(np.array(want))
            assert (got - want).abs().max() <= \
                REF_MOMENT_REL * want.abs().max(), k
        got = params[k].float()
        want = torch.from_numpy(np.asarray(j_params[k]).astype(np.float32))
        d = (got - want).abs()
        if dtype == torch.float32:
            assert d.max() <= REF_PARAM_REL * want.abs().max(), k
        else:
            assert bool((d <= _ulp(torch.maximum(got.abs(), want.abs()),
                                   8)).all()), k
            assert int((d > 0).sum()) <= REF_BF16_SHARE * d.numel(), k


def _refuse_kernel(monkeypatch):
    """Any K8 entry point, or its build, raises."""
    def boom(*a, **k):
        raise AssertionError("K8 was called")
    for name in ("global_norm", "update", "_library", "build"):
        monkeypatch.setattr(k8, name, boom)


def test_cpu_leaves_take_the_plain_version(monkeypatch):
    """CPU leaves never reach the kernel: nothing builds or launches."""
    _refuse_kernel(monkeypatch)
    before = dict(k8.launch_count)
    params, grads = _tree(4, torch.bfloat16, 1.0)
    cfg = adamw.AdamWConfig()
    params, state, met = adamw.apply_updates(params, grads[0],
                                             adamw.init_state(params), cfg)
    assert met["grad_norm"].device.type == "cpu"
    assert dict(k8.launch_count) == before


def _profiled_call(fn):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        return fn()


def test_meta_leaves_give_shapes_and_launch_nothing(monkeypatch):
    """The dry-run's ``meta`` tree goes through the plain version, which
    computes shapes and dtypes only, and counts nothing even while a
    profiler records."""
    _refuse_kernel(monkeypatch)
    before = dict(k8.launch_count)
    params = {k: torch.empty(s, dtype=torch.bfloat16, device="meta")
              for k, s in SHAPES.items()}
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    state = adamw.init_state(params)
    state = state._replace(step=torch.empty((), dtype=torch.int32,
                                            device="meta"))
    spans.counters()
    new_p, new_s, met = _profiled_call(lambda: adamw.apply_updates(
        params, grads, state, adamw.AdamWConfig()))
    assert spans.counters() == {}
    assert met["grad_norm"].device.type == "meta"
    assert met["grad_norm"].shape == () and \
        met["grad_norm"].dtype == torch.float32
    for k, s in SHAPES.items():
        assert new_p[k].shape == s and new_p[k].device.type == "meta"
        assert new_s.mu[k].shape == s and new_s.mu[k].dtype == torch.float32
    assert dict(k8.launch_count) == before


def _as_if_on_cuda(monkeypatch):
    """CPU tensors pass the dispatchers' and the wrapper's device checks,
    as CUDA tensors would."""
    monkeypatch.setattr(ops, "_plain", lambda x: False)
    monkeypatch.setattr(ops, "_cuda_only", lambda x, what: None)
    monkeypatch.setattr(k8, "_on_cuda", lambda x: True)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_leaf_of_another_type_raises_before_any_build(monkeypatch,
                                                           dtype):
    """A leaf of a type the kernel does not take raises ValueError in the
    wrapper, before it builds or launches anything; no path falls back."""
    def no_build(*a, **k):
        raise AssertionError("built")
    monkeypatch.setattr(k8, "_library", no_build)
    monkeypatch.setattr(k8, "build", no_build)
    _as_if_on_cuda(monkeypatch)
    before = dict(k8.launch_count)
    p = torch.zeros(16, dtype=dtype)
    g = torch.ones(16, dtype=dtype)
    m, v = torch.zeros(16), torch.zeros(16)
    with pytest.raises(ValueError, match="dtype"):
        ops.adamw_global_norm([g], 1.0)
    with pytest.raises(ValueError, match="dtype"):
        ops.adamw_update([p], [g], [m], [v], [0.1],
                         torch.ones((), dtype=torch.float32), lr=1e-3,
                         b1=0.9, b2=0.95, eps=1e-8, bc1=0.1, bc2=0.05)
    with pytest.raises(ValueError, match="dtype"):
        ops.adamw_update([torch.zeros(16, dtype=torch.bfloat16)], [g], [m],
                         [v], [0.1], torch.ones(()), lr=1e-3, b1=0.9,
                         b2=0.95, eps=1e-8, bc1=0.1, bc2=0.05)
    assert dict(k8.launch_count) == before


def test_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch):
    """CPU tensors (unmocked), mismatched lengths, float16 moments and a
    non-contiguous param all raise before any build."""
    def no_build(*a, **k):
        raise AssertionError("built")
    monkeypatch.setattr(k8, "_library", no_build)
    p, g = torch.zeros(16, dtype=torch.bfloat16), torch.ones(16)
    m, v, s = torch.zeros(16), torch.zeros(16), torch.ones(())
    hyper = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, bc1=0.1, bc2=0.05)
    with pytest.raises(ValueError, match="not CUDA"):
        k8.global_norm([g], 1.0)
    with pytest.raises(ValueError, match="not CUDA"):
        k8.update([p], [g], [m], [v], [0.0], s, **hyper)
    monkeypatch.setattr(k8, "_on_cuda", lambda x: True)
    with pytest.raises(ValueError, match="17 grads"):
        k8.update([p], [torch.ones(17)], [m], [v], [0.0], s, **hyper)
    with pytest.raises(ValueError, match="dtype"):
        k8.update([p], [g], [m.half()], [v], [0.0], s, **hyper)
    with pytest.raises(ValueError, match="non-contiguous"):
        k8.update([torch.zeros(4, 4, dtype=torch.bfloat16).t()], [g],
                  [m], [v], [0.0], s, **hyper)
    with pytest.raises(ValueError, match="1 params, 1 grads, 1 and 1 "
                                         "moments, 2 decays"):
        k8.update([p], [g], [m], [v], [0.0, 0.1], s, **hyper)


def test_tables_group_by_dtype_pair_and_cut_at_max_leaves():
    """Leaves go to launches by (param, grad) dtype pair, in leaf order,
    at most MAX_LEAVES a launch: Mixtral's 13 stacked leaves are one."""
    assert k8._tables(["bf"] * 13) == [list(range(13))]
    assert k8._tables(["bf"] * 40) == [list(range(16)), list(range(16, 32)),
                                       list(range(32, 40))]
    assert k8._tables(["a", "b", "a", "b", "a"]) == [[0, 2, 4], [1, 3]]
    assert k8._tables([]) == []


def _profiled(fn):
    _profiled_call(fn)
    return spans.counters()


def test_counters_count_elements_by_path_only_while_profiled(monkeypatch):
    """``adamw.plain`` counts the elements the plain version updated and
    ``adamw.fused`` those the kernel did, once a step, and only while a
    profiler records."""
    spans.counters()
    params, grads = _tree(5, torch.bfloat16, 1.0)
    n = sum(x.numel() for x in params.values())
    cfg = adamw.AdamWConfig()
    state = adamw.init_state(params)

    def step():
        adamw.apply_updates(params, grads[0], state, cfg)
    step()
    assert spans.counters() == {}
    assert _profiled(step) == {"adamw.plain": n}
    _as_if_on_cuda(monkeypatch)
    calls = []

    def fused_norm(gs, clip):
        calls.append("norm")
        return ref.adamw_global_norm_ref(gs, clip)

    def fused_update(ps, gs, ms, vs, wds, scale, **hyper):
        calls.append("update")
        for p, g, m, v, wd in zip(ps, gs, ms, vs, wds):
            ref.adamw_update_ref(p, g, m, v, scale, wd=wd, **hyper)
    monkeypatch.setattr(k8, "global_norm", fused_norm)
    monkeypatch.setattr(k8, "update", fused_update)
    step()
    assert spans.counters() == {} and calls == ["norm", "update"]
    assert _profiled(step) == {"adamw.fused": n}


# -- on the card ------------------------------------------------------------

#: the moments, normwise: |kernel - plain| <= MOMENT_REL * max|plain|.  The
#: card's plain version divides by a host scalar as a multiply by its
#: reciprocal and chooses its own fused multiply-adds, where the kernel
#: rounds each operation as the CPU does: an ulp or so an element
MOMENT_REL = 2e-6
#: bf16 params: apart on under this share of elements, and each apart by at
#: most one bf16 ulp of the result (a float32 difference in p - lr u that
#: flips the final rounding) plus F32_ULPS float32 ulps of the larger of
#: |p| and |lr u| (the float32 difference itself, which where p - lr u
#: cancels is many of the small result's own ulps)
ULP_SHARE = 1e-4
F32_ULPS = 16
#: the norm: the kernel sums in another order (tiles of 4096-8192
#: elements, then the partials in double) than the plain slice loop
GNORM_REL = 1e-5


def _cuda_case(n, offset, p_dtype, g_dtype, gen):
    def buf(dtype, scale):
        x = torch.randn(n + offset, generator=gen, device="cuda") * scale
        return x.to(dtype)[offset:]
    p, g = buf(p_dtype, 0.02), buf(g_dtype, 1e-3)
    m = buf(torch.float32, 1e-4)
    v = buf(torch.float32, 1e-4).square()
    return p, g, m, v


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32),
                                  (torch.float32, torch.bfloat16)],
                         ids=["bf16", "f32", "bf16_f32grad", "f32_bf16grad"])
def test_cuda_kernel_matches_plain_version(pair):
    """K8's norm and update against the plain version on the card, on
    leaves aligned and one element off, long and short, decayed and not:
    one norm launch, one finalize and one update launch."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [_cuda_case(n, off, *pair, gen) for n, off in (
        ((1 << 20) + 3, 0), (4096, 0), (1000, 1), (1, 0), (77777, 1))]
    wds = [0.1, 0.0, 0.1, 0.0, 0.1]
    want = [tuple(x.clone() for x in c) for c in cases]
    olds = [c[0].float() for c in cases]
    before = dict(k8.launch_count)
    gnorm, scale = ops.adamw_global_norm([c[1] for c in cases], 1.0)
    w_norm, w_scale = ref.adamw_global_norm_ref([c[1] for c in cases], 1.0)
    hyper = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, bc1=0.40951,
                 bc2=0.22621906)
    ops.adamw_update(*zip(*cases), wds, scale, **hyper)
    for (p, g, m, v), wd in zip(want, wds):
        ref.adamw_update_ref(p, g, m, v, scale, wd=wd, **hyper)
    torch.cuda.synchronize()
    assert abs(float(gnorm) / float(w_norm) - 1) <= GNORM_REL
    assert abs(float(scale) / float(w_scale) - 1) <= GNORM_REL
    assert k8.launch_count["norm"] == before.get("norm", 0) + 1
    assert k8.launch_count["update"] == before.get("update", 0) + 1
    for got, ref_, old in zip(cases, want, olds, strict=True):
        for x, y in zip(got[2:], ref_[2:]):
            assert (x - y).abs().max() <= MOMENT_REL * y.abs().max()
        p, q = got[0], ref_[0]
        if p.dtype == torch.bfloat16:
            p, q = p.float(), q.float()
            d = (p - q).abs()
            assert bool((d <= _ulp(torch.maximum(p.abs(), q.abs()), 8)
                         + F32_ULPS * _ulp(torch.maximum(
                             old.abs(), (old - q).abs()), 24)).all())
            assert int((d > 0).sum()) <= ULP_SHARE * p.numel()
        else:
            assert (p - q).abs().max() <= MOMENT_REL * q.abs().max()
