"""Serving across devices in the port against the JAX reference.

The parameters are the reference's ``init_params`` trees (float32)
carried across by ``convert.py``; tokens come from a seeded numpy
generator.  On one process: ``chunked_attention``'s ``k_offset`` and
``with_stats`` (the sequence-sharded decode's partials) at 3 shapes
(1e-5), and ``launch/shapes.py`` against the reference's for the ten
configs at their four input shapes, and a batch-1 decode shape, on one
device and on (tp=4, dp=2); the serve launcher's communicator flags.

On a (data=2, model=2) mesh, 4 gloo ranks spawned once (rank side in
``_torch_ranks.serve_sharded``) against the reference's
``launch.steps.build_serve_program`` on the conftest's CPU devices, the
model axis's all-reduce and all-gather slots pinned to primary 50 /
staged 25 / ortho 25: reduced glm4-9b with the cache sequence-sharded
over model (batch 2) and over data x model (batch 1), mixtral-8x7b (moe,
a dense prefix layer, a sliding window the steps outrun), zamba2-1.2b
(hybrid, SSM heads over model; both modes) and whisper-medium (encdec,
its cross-attention cache random): each rank's logits every step and its
final cache equal the reference's block at its mesh position (1e-5), are
within 2e-3 of the port's local decode, the greedy streams are bit-equal
to the reference's, and what the communicators recorded after one step
(the ``q_ag`` sub-recorder included) and their plan signatures equal the
reference's.  ``paged_decode_step`` on a ctx of the model axis alone,
with the dense gather and the kernel (its plain version here), against
the reference's under a ``shard_map`` on (model=2).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks
from repro.compat import shard_map
from repro.configs import ALIASES as J_ALIASES
from repro.configs import get_config as j_get_config
from repro.core import communicator as j_comm
from repro.launch import shapes as JSH
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_serve_program as j_build_serve_program
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.tp import ParallelCtx as JParallelCtx
from repro_torch.convert import params_from_reference
from repro_torch.core.communicator import bucket_for
from repro_torch.launch import serve as t_serve
from repro_torch.launch import shapes as TSH
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import layers as TL
from repro_torch.models import single_device_ctx as t_ctx
from repro_torch.models import transformer as TT

TOL = 1e-5          # a rank against the reference's block, float32
LOCAL = 2e-3        # sharded against local decode: the reference's bound
PROFILE = "h800"
SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}
PROMPT = 3          # teacher-forced steps before the greedy ones
#: name -> arch, global batch (1: the cache over data x model), the
#: cache's global length, steps, MoE overrides
CASES = {
    "glm4-model": dict(arch="glm4-9b", batch=2, seq=16, steps=10),
    "glm4-model_data": dict(arch="glm4-9b", batch=1, seq=16, steps=10),
    # a dense prefix layer; window 16 bites after step 16; capacity
    # covers every token, so one data row's routing equals the batch's
    "mixtral-model": dict(arch="mixtral-8x7b", batch=2, seq=32, steps=20,
                          moe=dict(n_dense_prefix=1, capacity_factor=8.0)),
    "zamba2-model": dict(arch="zamba2-1.2b", batch=2, seq=16, steps=10),
    "zamba2-model_data": dict(arch="zamba2-1.2b", batch=1, seq=16,
                              steps=10),
    "whisper-model": dict(arch="whisper-medium", batch=2, seq=16, steps=10),
}
ARCHS = sorted({c["arch"] for c in CASES.values()})
#: paged_decode_step at (model=2): request 0 in blocks (4, 7, 1), request
#: 1 in (2, 9, 5); each tick is (row_req, positions, sample_rows); -1 rows
#: are bucket padding
TABLES = np.array([[4, 7, 1], [2, 9, 5]], np.int32)
TICKS = [
    ([0, 0, 0, 0, 0, 1, 1, 1], [0, 1, 2, 3, 4, 0, 1, 2], [4, 7]),
    ([0, 1, -1, -1], [5, 3, 0, 0], [0, 1]),
    ([1, 0, 1, 1, -1, -1, -1, -1], [4, 6, 5, 6, 0, 0, 0, 0], [1, 3]),
]
PCFG = dict(block_size=8, n_blocks=10, max_blocks_per_req=3)


def j_config(case):
    """The reference's reduced config of a case, with its MoE overrides."""
    cfg = j_get_config(case["arch"]).reduced()
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return cfg


def _shape(name, case):
    return JSH.InputShape(name, "decode", case["seq"], case["batch"])


def _rank(r):
    """(coords, sizes) of rank r on the (data=2, model=2) mesh."""
    d, m = divmod(r, 2)
    return {"data": d, "model": m}, {"data": 2, "model": 2}


def _logits_block(full, case, r):
    """Rank r's block of global [B, V] logits: its rows over data (batch >
    1), its vocabulary half."""
    coords, sizes = _rank(r)
    spec = ("data" if case["batch"] > 1 else None, "model")
    return _torch_ranks.spec_block(full, spec, coords, sizes)


# ---------------------------------------------------------------------------
# chunked_attention: k_offset and with_stats
# ---------------------------------------------------------------------------

ATTN_SHAPES = {
    # (B, Sq, Hq, Hkv, Skv, hd, q_offset, k_offset, kv_valid, window,
    # chunk): a cache slice at a nonzero offset with a padded tail, the
    # query inside it; a slice wholly after the query (all masked); a
    # sliding window across the slice's start
    "inside": (2, 1, 4, 2, 13, 16, 20, 16, 21, None, 8),
    "after": (1, 1, 4, 1, 8, 8, 3, 8, 4, None, 8),
    "window": (2, 2, 8, 2, 24, 16, 30, 12, 32, 10, 16),
}


@pytest.mark.parametrize("case", list(ATTN_SHAPES))
def test_chunked_attention_offsets_and_stats_match_reference(case):
    """The un-normalised (acc, running max, denominator) at global key
    positions ``k_offset + j``, the padded tail masked by local index, and
    the normalised output, within 1e-5; -inf maxima in the same places."""
    b, sq, hq, hkv, skv, hd, q_off, k_off, kv_valid, window, chunk = \
        ATTN_SHAPES[case]
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, hq, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    kw = dict(causal=True, window=window, q_offset=q_off, k_offset=k_off,
              kv_valid=kv_valid, chunk=chunk)
    for stats in (True, False):
        want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                    with_stats=stats, **kw)
        got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                   with_stats=stats, **kw)
        for g, w in zip(got, want) if stats else [(got, want)]:
            w = np.asarray(w)
            g = g.numpy()
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            real = np.isfinite(w)
            np.testing.assert_allclose(g[real], w[real], atol=TOL, rtol=TOL)
    if case == "after":                  # every key after the query
        _, m, l = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       with_stats=True, **kw)
        assert bool(torch.isinf(m).all()) and not bool(l.any())


# ---------------------------------------------------------------------------
# launch/shapes.py
# ---------------------------------------------------------------------------

def _spec(p):
    """A reference PartitionSpec as the port's per-dim tuple."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return _spec(tree)


@pytest.mark.parametrize("arch", sorted(J_ALIASES))
def test_shapes_match_reference(arch):
    """``input_specs`` (shapes, dtypes), ``input_partition_specs`` and
    ``decode_config`` equal the reference's for the four SHAPES and a
    batch-1 decode_32k, on one device and on (tp=4, dp=2); pure shape
    probes (no communicator)."""
    from repro_torch.configs import get_config
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert TSH.SHAPES == {k: TSH.InputShape(**dataclasses.asdict(v))
                          for k, v in JSH.SHAPES.items()}
    shapes = list(JSH.SHAPES.values()) + [dataclasses.replace(
        JSH.SHAPES["decode_32k"], global_batch=1)]
    for shape in shapes:
        tshape = TSH.InputShape(**dataclasses.asdict(shape))
        for tp, dp in ((1, 1), (4, 2)):
            if jcfg.n_heads and jcfg.n_heads % tp:
                continue
            want = JSH.input_specs(jcfg, shape, tp=tp, dp=dp)
            got = TSH.input_specs(tcfg, tshape, tp=tp, dp=dp)
            flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
            assert len(flat_w) == len(jax.tree.leaves(want))
            for path, w in flat_w:
                g = got
                for key in path:
                    g = g[key.key]
                assert g.device.type == "meta"
                assert tuple(g.shape) == w.shape, (shape.name, tp, path)
                assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            assert _keys(got) == _keys(want)
            assert TSH.input_partition_specs(
                tcfg, tshape, tp=tp, dp=dp) == _specs(
                    JSH.input_partition_specs(jcfg, shape, tp=tp, dp=dp))
            if shape.kind == "decode":
                w = JSH.decode_config(jcfg, shape, tp=tp, dp=dp)
                g = TSH.decode_config(tcfg, tshape, tp=tp, dp=dp)
                assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert TSH.needs_swa_override(tcfg, TSH.SHAPES["long_500k"]) == \
        JSH.needs_swa_override(jcfg, JSH.SHAPES["long_500k"])
    assert TSH.batch_axes(2, 3) == JSH.batch_axes(2, 3)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


# ---------------------------------------------------------------------------
# the serve program on (data=2, model=2): 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded")
    (d / "json").mkdir()
    # the decode combines: [B_local = 1, 1, d_model] float32; the Q
    # gather: [Hq_l = 2, 1, 1, hd] float32
    buckets = {bucket_for(256 * 4), bucket_for(2 * 64 * 4)}
    pinned = str(d / "pinned.json")
    for bucket in sorted(buckets):
        _torch_ranks.pinned_profile(pinned, PROFILE, 2, SHARES,
                                    ops=("all_reduce", "all_gather"),
                                    bucket=bucket)
    rng = np.random.default_rng(22)
    cases = {}
    for name, case in CASES.items():
        cfg = j_config(case)
        c = dict(case, prompt=rng.integers(
            1, cfg.vocab, (case["batch"], PROMPT)).astype(np.int32))
        if cfg.family == "encdec":
            spec = JSH.input_specs(cfg, _shape(name, case), tp=2,
                                   dp=2)["cache"]
            c["cache"] = {k: (rng.standard_normal(spec[k].shape) * 0.5
                              ).astype(np.float32) for k in ("xk", "xv")}
        cases[name] = c
    paged = dict(arch="glm4-9b", pcfg=PCFG, ticks=[
        (rng.integers(1, 512, len(rows)).astype(np.int32),
         np.array(pos, np.int32), np.array(rows, np.int32), TABLES,
         np.array(sample, np.int32)) for rows, pos, sample in TICKS])
    return {"dir": d, "comm": {"profile": PROFILE, "tuning_cache": pinned},
            "cases": cases, "paged": paged}


@pytest.fixture(scope="module")
def inits():
    def init(arch):
        cfg = j_config(next(c for c in CASES.values() if c["arch"] == arch))
        return jax.tree.map(np.asarray, jax.jit(
            j_init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    return {arch: init(arch) for arch in ARCHS}


def _ref_case(name, case, init, comm, json_dir):
    """The reference's serve program on (data=2, model=2) for one case:
    the global logits each step, the stream, the recording after step 1,
    the final global cache."""
    cfg = j_config(case)
    shape = _shape(name, case)
    j_comm.comm_destroy_all()
    mesh = make_mesh((2, 2), ("data", "model"))
    program, ctx, _ = j_build_serve_program(
        cfg, mesh, shape, comm=j_comm.CommConfig(**comm), name="serve")
    params = jax.tree.map(jnp.asarray, init)
    cache = {k: jnp.zeros(s.shape, s.dtype) for k, s in JSH.input_specs(
        cfg, shape, tp=2, dp=2)["cache"].items()}
    for k, v in case.get("cache", {}).items():
        cache[k] = jnp.asarray(v)
    toks = [case["prompt"][:, t] for t in range(PROMPT)]
    out = {"logits": []}
    with mesh:
        for t in range(case["steps"]):
            logits, cache = program.step(params, cache,
                                         jnp.asarray(toks[t][:, None]),
                                         jnp.int32(t))
            logits = np.asarray(logits)
            out["logits"].append(logits)
            if t == 0:
                out["recording"] = _torch_ranks.recording(
                    ctx, "serve", str(json_dir / f"ref-{name}.json"))
                out["q_ag"] = {c.axis_name: [
                    (op.value, n, win) for op, n, win in
                    c.recorder("serve/q_ag").issued_calls()]
                    for c in ctx.comms()}
            if t + 1 >= len(toks):
                toks.append(logits.argmax(-1).astype(np.int32))
    program.close()
    out["stream"] = np.stack(toks, 1)
    out["cache"] = {k: np.asarray(v) for k, v in cache.items()}
    j_comm.comm_destroy_all()
    return out


def _ref_paged(paged, init, comm):
    """The reference's paged_decode_step under a shard_map on (model=2),
    for each impl: the global logits each tick and the global pool."""
    cfg = j_config(paged)
    j_comm.comm_destroy_all()
    mesh = make_mesh((2,), ("model",))
    ctx = JParallelCtx(tp_axis="model", tp_size=2,
                       comm_config=j_comm.CommConfig(**comm))
    pool_sp = {"k": P(None, None, None, "model", None),
               "v": P(None, None, None, "model", None)}
    out = {}
    for impl in ("reference", "kernel"):
        pcfg = JT.PagedConfig(attn_impl=impl, **paged["pcfg"])

        def step(p, pool, *args):
            return JT.paged_decode_step(p, pool, *args, cfg, ctx, pcfg)
        fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(
            JT.param_specs(cfg), pool_sp) + (P(),) * 5, out_specs=(
            P(None, "model"), pool_sp), check_vma=False))
        local = JT.init_paged_pool(cfg, JParallelCtx(tp_size=2), pcfg)
        pool = {k: jnp.concatenate([v, v], axis=3) for k, v in local.items()}
        logits = []
        with mesh:
            for tick in paged["ticks"]:
                lg, pool = fn(jax.tree.map(jnp.asarray, init), pool,
                              *map(jnp.asarray, tick))
                logits.append(np.asarray(lg))
        out[impl] = {"logits": logits,
                     "pool": {k: np.asarray(v) for k, v in pool.items()}}
    j_comm.comm_destroy_all()
    return out


@pytest.fixture(scope="module")
def reference(work, inits):
    out = {name: _ref_case(name, case, inits[case["arch"]], work["comm"],
                           work["dir"] / "json")
           for name, case in work["cases"].items()}
    out["paged"] = _ref_paged(work["paged"], inits["glm4-9b"], work["comm"])
    return out


@pytest.fixture(scope="module")
def port(work, inits, reference):
    return run_ranks(_torch_ranks.serve_sharded, 4, backend="gloo",
                     device="cpu", timeout_s=600,
                     args=(inits, work["cases"], work["comm"],
                           work["paged"], str(work["dir"] / "json")))


@pytest.mark.parametrize("name", list(CASES))
def test_serve_step_matches_reference_shards(port, reference, name):
    """Every step's logits [B_local, V_local] and the final cache of each
    rank equal the reference's block at its mesh position (rank = data * 2
    + model), within 1e-5."""
    case = CASES[name]
    ref = reference[name]
    cfg = j_config(case)
    specs = _specs(JSH.input_partition_specs(cfg, _shape(name, case), tp=2,
                                             dp=2)["cache"])
    for r, res in enumerate(port):
        got = res[name]
        assert len(got["logits"]) == case["steps"]
        for t, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            w = _logits_block(w, case, r)
            assert g.shape == w.shape, (r, t)
            real = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), real)
            np.testing.assert_allclose(g[real], w[real], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} step {t}")
        assert got["cache"].keys() == ref["cache"].keys()
        for k, w in ref["cache"].items():
            w = _torch_ranks.spec_block(w, specs[k], *_rank(r))
            np.testing.assert_allclose(got["cache"][k], w, atol=TOL,
                                       rtol=TOL, err_msg=f"rank {r} {k}")


def _local_logits(case, stream, init):
    """The port's decode over a local cache (seq_shard None) on one device,
    the global tokens ``stream`` teacher-forced: the logits [B, V] of each
    step."""
    cfg = _torch_ranks.serve_config(case)
    dcfg = TT.DecodeConfig(cache_len_local=case["seq"], seq_shard=None)
    cache = TT.init_cache(cfg, t_ctx(), dcfg, case["batch"])
    for k, v in case.get("cache", {}).items():
        # the sharded cache's one cross-attention head, for every head
        cache[k].copy_(torch.from_numpy(np.repeat(v, cfg.n_kv_heads, 3)))
    params = params_from_reference(init)
    out = []
    with torch.no_grad():
        for t in range(case["steps"]):
            lg, cache = TT.decode_step(params, cache, torch.from_numpy(
                np.ascontiguousarray(stream[:, t:t + 1])), t, cfg, t_ctx(),
                dcfg)
            out.append(lg.numpy())
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_serve_step_matches_local_decode(port, work, inits, name):
    """Each rank's logits every step are within 2e-3 (the reference's own
    bound, tests/test_integration.py) of the decode over a LOCAL cache
    (``seq_shard=None``) on the same ranks, the same tokens fed; and,
    for the attention families, of its block of the port's local decode
    on one device.  A Mamba2 block at tp = 2 normalises its gated output
    over each shard's heads, as the reference's does, so the hybrid's
    logits on the model axis are not one device's."""
    case = work["cases"][name]
    one = _local_logits(case, port[0][name]["stream"], inits[case["arch"]])
    ssm = _torch_ranks.serve_config(case).ssm is not None
    for r, res in enumerate(port):
        wants = [res[name]["local"]] + ([] if ssm else [
            [_logits_block(w, case, r) for w in one]])
        for want in wants:
            for t, (g, w) in enumerate(zip(res[name]["logits"], want)):
                real = np.isfinite(w)
                np.testing.assert_array_equal(np.isfinite(g), real)
                np.testing.assert_allclose(g[real], w[real], atol=LOCAL,
                                           rtol=LOCAL,
                                           err_msg=f"rank {r} step {t}")


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_streams_match_reference(port, reference, name):
    """The prompt, then greedy tokens from the logits gathered over the
    mesh: bit-equal to the reference's stream, on every rank."""
    want = reference[name]["stream"]
    assert want.shape == (CASES[name]["batch"], CASES[name]["steps"] + 1)
    for res in port:
        np.testing.assert_array_equal(res[name]["stream"], want)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_recording_matches_reference(port, reference, name):
    """After one step, both axes' recorded calls, the ``q_ag``
    sub-recorder's, the plan signatures and the saved TuningProfile equal
    the reference's: on the model axis the embedding combine, then one
    block of each scan (the prefix's block and the first MoE block; the
    hybrid's first Mamba2 block and shared block, once for its groups);
    one Q all-gather a trace in its own issue window; nothing on the
    data axis."""
    want = reference[name]["recording"]
    got = port[0][name]["recording"]
    for axis in ("model", "data"):
        assert got[axis]["calls"] == want[axis]["calls"], axis
        assert got[axis]["signature"] == want[axis]["signature"], axis
    assert got["profile_json"] == want["profile_json"]
    assert port[0][name]["q_ag"] == reference[name]["q_ag"]
    # one gather a scan trace, and one each block of the moe prefix
    n_ag = 1 + bool(CASES[name].get("moe", {}).get("n_dense_prefix"))
    assert [c[:2] for c in port[0][name]["q_ag"]["model"]] == [
        ("all_gather", 2 * 64 * 4)] * n_ag
    assert {c[2] for c in port[0][name]["q_ag"]["model"]} == {1}
    assert got["data"]["calls"] == []
    assert all(r[name]["recording"]["model"] == got["model"]
               and r[name]["q_ag"] == port[0][name]["q_ag"] for r in port)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_tp_paged_decode_matches_reference(port, reference, impl):
    """``paged_decode_step`` at (model=2), this shard's Q heads and KV
    head: each rank's logits every tick and its pool equal the reference's
    shard_map block (1e-5); the kernel impl runs the flash-decode kernel's
    plain version here, the reference's Pallas kernel in interpret mode."""
    want = reference["paged"][impl]
    for r, res in enumerate(port):
        got = res[f"paged-{impl}"]
        m = r % 2
        for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            w = w[:, m * g.shape[1]:(m + 1) * g.shape[1]]
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} tick {t}")
        for k, w in want["pool"].items():
            np.testing.assert_allclose(got["pool"][k], w[:, :, :, m:m + 1],
                                       atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the serve launcher's communicator flags
# ---------------------------------------------------------------------------

def test_serve_launcher_flags_take_the_reference_note(tmp_path, capsys):
    """``--tuning-cache --timing --secondary-algo --compress`` go into the
    one-device ctx's CommConfig; there is no communicator, so the
    launcher prints the reference's note, serves, and saves the (empty)
    tuning profile as the reference does."""
    cache = tmp_path / "tuning.json"
    rc = t_serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--tuning-cache", str(cache),
                       "--timing", "measured", "--secondary-algo", "tree",
                       "--compress", "secondary=fp8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("note: single-device launch has no communicators — --timing/"
            "--tuning-cache/--secondary-algo/--nodes/--degrade/--fault/"
            "--compress take effect only with parallel axes") in out
    assert f"tuning profile: 0 slots -> {cache}" in out
    assert "served 2 requests" in out


@pytest.mark.parametrize("flags,item", [
    (["--nodes", "2"], "item 12"), (["--nodes", "2", "--pods", "2"],
                                     "item 14"),
    (["--degrade", "nvlink=0.5"], "item 13"),
    (["--fault", "nvlink@step2=0.5"], "item 13")])
def test_serve_launcher_refuses_unported_tiers(flags, item, capsys,
                                               tmp_path):
    """Every tier flag is ported, each by the ROADMAP item named.
    ``--nodes`` and the launch-time ``--degrade`` came with the two-tier
    cluster (item 12), as the reference's: ``--nodes 2`` serves on one
    device and reports the cluster it registered, equal to the
    reference's ``cluster_for``; ``--pods`` with the pod tier (item 14):
    ``--nodes 2 --pods 2`` registers the three-tier cluster, equal to the
    reference's ``cluster_for(..., pods=2)``; ``--degrade``
    serves on the degraded profile, named as the reference's
    ``resolve_faults`` names it.  ``--fault`` came with the fault tier
    (item 13): it serves, the engine ticks the clock, and the record
    carries the clock's report, equal to the reference's clock's over the
    same ticks (the one-device ctx has no communicator to re-key)."""
    from repro.cluster.topology import cluster_for as j_cluster_for
    from repro.configs.clusters import resolve_faults as j_resolve
    from repro.faults import FabricClock as JClock
    rec = tmp_path / "serve.json"
    rc = t_serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--out", str(rec), *flags])
    out, err = capsys.readouterr()
    assert rc == 0 and "served 2 requests" in out
    got = json.loads(rec.read_text())
    if flags[0] == "--fault":
        _, profile, timeline = j_resolve(None, 1, "h100", fault=flags[1])
        assert got["profile"] == profile == "h100"
        clock = JClock(timeline)
        for tick in range(got["serving"]["ticks"]):
            clock.advance(tick)
        assert got["faults"] == json.loads(json.dumps(clock.report()))
        assert got["faults"]["schedule"] == ["nvlink@step2=0.5"]
        assert "faults: 0 transition(s), 0 re-key(s)" in out
        return
    assert "faults" not in got
    if flags[0] == "--nodes":
        pods = 2 if "--pods" in flags else 1
        want = j_cluster_for("h100", 2, pods=pods)
        assert got["cluster"] == want.describe()
        assert f"NIC tier {want.nic_tier.name}" in out
        assert (want.pod_tier is not None) == (pods > 1)
        if pods > 1:
            assert f"2 pods, pod tier {want.pod_tier.name}" in out
        assert got["profile"] == "h100"
    else:
        assert got["cluster"] is None
        assert got["profile"] == j_resolve(None, 1, "h100",
                                           degrade=flags[1])[1]
        assert got["profile"] == "h100!nvlink=0.5"
