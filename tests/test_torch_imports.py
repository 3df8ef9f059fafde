"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the reference package
``repro`` — checked statically (AST) and by importing every port module
in a fresh interpreter."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    names = list(_imported(ast.parse(path.read_text())))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 20


def test_the_training_slice_is_checked():
    """The data-parallel train step's modules are among those checked
    above, the codec kernels and their wrappers included."""
    for m in ("repro_torch.kernels.codec", "repro_torch.optim.adamw",
              "repro_torch.data.pipeline",
              "repro_torch.checkpoint.checkpointer",
              "repro_torch.train.train_step", "repro_torch.train.loop",
              "repro_torch.launch.steps", "repro_torch.launch.train"):
        assert m in MODULES, m
    assert (PORT / "kernels" / "csrc" / "codec.cu").exists()


def test_the_fault_slice_is_checked():
    """The fault tier's modules are among those checked above: the copied
    clock, the elastic resume and the loop and mesh they drive."""
    for m in ("repro_torch.faults", "repro_torch.faults.clock",
              "repro_torch.faults.elastic", "repro_torch.faults.schedule",
              "repro_torch.train.loop", "repro_torch.launch.mesh"):
        assert m in MODULES, m


def test_the_cluster_slice_is_checked():
    """The two-tier cluster's modules are among those checked above: the
    copied topology, simulator, cluster presets and fault schedule, and
    the hierarchical communicator."""
    for m in ("repro_torch.cluster", "repro_torch.cluster.topology",
              "repro_torch.cluster.simulator",
              "repro_torch.cluster.communicator",
              "repro_torch.configs.clusters", "repro_torch.faults",
              "repro_torch.faults.schedule"):
        assert m in MODULES, m


def test_the_pod_slice_is_checked():
    """The pod tier's modules are among those checked above: the mesh with
    its gradient plane, the three-tier communicator, the ctx, the MoE
    dispatch, the shard and checkpoint code of the ep span and both
    launchers."""
    for m in ("repro_torch.launch.mesh", "repro_torch.cluster.communicator",
              "repro_torch.models.tp", "repro_torch.models.moe",
              "repro_torch.convert", "repro_torch.checkpoint.checkpointer",
              "repro_torch.launch.steps", "repro_torch.train.loop",
              "repro_torch.launch.train", "repro_torch.launch.serve"):
        assert m in MODULES, m


def test_the_tensor_parallel_slice_is_checked():
    """The modules the tensor-parallel train step added or changed are
    among those checked above: K7's wrapper and source, the differentiable
    collectives (routing, the mesh's psum) and the model-axis ctx."""
    for m in ("repro_torch.kernels.payload_partition",
              "repro_torch.core.routing", "repro_torch.core.communicator",
              "repro_torch.launch.mesh", "repro_torch.models.tp",
              "repro_torch.convert"):
        assert m in MODULES, m
    assert (PORT / "kernels" / "csrc" / "payload_partition.cu").exists()


class _TensorParallel:
    """The part of a model-axis ParallelCtx the decode paths read: tp = 2,
    this rank model index 0, combines that pass through, no
    communicators."""
    tp_size = 2

    def tp_index(self):
        return 0

    def tp_all_reduce(self, x):
        return x

    def comms(self):
        return ()


def test_decode_paths_refuse_tensor_parallel():
    """Serving across devices (ROADMAP queue 1 item 11) is ported: at
    tp = 2 the dense decode path over a local cache and paged attention
    run on this shard's heads (reduced glm4-9b: 2 of 4 Q heads, 1 of 2 KV
    heads) and return this shard's shapes; the decode cache holds every KV
    head when sequence-sharded and this shard's otherwise, the paged pool
    this shard's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_config("glm4-9b").reduced()
    ctx = _TensorParallel()
    gen = torch.Generator().manual_seed(0)
    p = shard_params(L.init_attention(gen, cfg, torch.float32, "cpu"),
                     L.attention_specs(cfg), 0, ctx.tp_size)
    x = torch.randn(1, 1, cfg.d_model, generator=gen)
    hd = cfg.head_dim_
    assert L.head_layout(cfg, ctx) == (2, 1, 2)
    cache = (torch.zeros(1, 8, 1, hd), torch.zeros(1, 8, 1, hd))
    out, (ck, cv) = L.attention_block(p, x, cfg, ctx, kv_cache=cache,
                                      cache_pos=3)
    assert out.shape == (1, 1, cfg.d_model) and bool(out.isfinite().all())
    assert ck.shape == cv.shape == (1, 8, 1, hd)
    assert bool(ck[:, 3].any()) and not bool(ck[:, :3].any())
    pools = (torch.zeros(4, 16, 1, hd), torch.zeros(4, 16, 1, hd))
    out, (kp, vp) = L.paged_attention_block(
        p, x, cfg, ctx, positions=torch.zeros(1, dtype=torch.long),
        kv_valid=torch.ones(1, dtype=torch.long), pools=pools,
        block_tables=torch.zeros(1, 1, dtype=torch.long))
    assert out.shape == (1, 1, cfg.d_model) and bool(out.isfinite().all())
    assert kp.shape == (4, 16, 1, hd) and bool(kp[0, 0].any())
    c = T.init_cache(cfg, ctx, T.DecodeConfig(cache_len_local=8), 1)
    assert c["k"].shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads, hd)
    c = T.init_cache(cfg, ctx, T.DecodeConfig(cache_len_local=8,
                                              seq_shard=None), 1)
    assert c["k"].shape == (cfg.n_layers, 1, 8, 1, hd)
    pool = T.init_paged_pool(cfg, ctx, T.PagedConfig())
    assert pool["k"].shape == (cfg.n_layers, 64, 16, 1, hd)
    # training and prefill attention (no cache) run at tp > 1
    out, _ = L.attention_block(p, torch.zeros(1, 3, cfg.d_model), cfg, ctx)
    assert out.shape == (1, 3, cfg.d_model)


@pytest.mark.parametrize("paged", ["on", "off"])
def test_serve_launcher_refuses_tensor_parallel(monkeypatch, paged):
    """The serve launcher's engines are one-device, as the reference's:
    given a ctx with a model axis wider than 1 they refuse it, pointing to
    the serve program (launch/steps.build_serve_program)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "ParallelCtx",
                        lambda **kw: _TensorParallel())
    with pytest.raises(ValueError, match="one-device.*build_serve_program"):
        serve.main(["--smoke", "--device", "cpu", "--paged", paged,
                    "--requests", "1"])


def test_the_dryrun_slice_is_checked():
    """The dry-run's modules are among those checked above: the driver,
    the roofline (analytic model, the card's summary), the dry mesh, the
    step helpers and ``StepProgram.lower``."""
    for m in ("repro_torch.launch.dryrun", "repro_torch.roofline",
              "repro_torch.roofline.analytic",
              "repro_torch.roofline.analysis", "repro_torch.launch.mesh",
              "repro_torch.launch.steps", "repro_torch.runtime.program"):
        assert m in MODULES, m


def test_dry_mesh_refuses_a_cpu_tensor():
    import torch
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh.dry((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="meta tensors only"):
        mesh.all_reduce(torch.ones(4), "model")
    out = mesh.all_reduce(torch.ones(4, device="meta"), "model")
    assert out.device.type == "meta" and out.shape == (4,)


def test_ops_send_meta_to_the_plain_version_and_cpu_never_to_a_kernel(
        monkeypatch):
    """kernels/ops.py: a meta operand takes the plain version (shapes and
    dtypes only), a CPU one too; neither ever reaches a kernel wrapper."""
    import torch
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, flash_decode, ops, ref
    from repro_torch.kernels import payload_partition as pp
    plain = []
    for name in ("chunk_accumulate_ref", "bf16_pack_ref", "fp8_encode_ref",
                 "fp8_decode_ref", "fp8_decode_accumulate_ref",
                 "extract_segment_ref", "merge_segments_ref",
                 "paged_flash_decode_ref"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=fn, **k: (
            plain.append(_n), _f(*a, **k))[1])

    def kernel(*a, **k):
        raise AssertionError("a kernel wrapper was called")
    for mod, names in ((ca, ("chunk_accumulate",
                             "chunk_accumulate_segments")),
                       (codec, ("bf16_pack", "bf16_pack_segments",
                                "fp8_encode", "fp8_decode",
                                "fp8_decode_accumulate")),
                       (pp, ("extract", "merge")),
                       (flash_decode, ("paged_flash_decode_pool",))):
        for n in names:
            monkeypatch.setattr(mod, n, kernel)
    for dev in ("meta", "cpu"):
        plain.clear()
        a = torch.ones(256, device=dev)
        b = torch.ones(256, dtype=torch.bfloat16, device=dev)
        outs = [ops.accumulate(a, a), ops.accumulate_many([a], [a])[0],
                ops.wire_roundtrip(a, codec_name="fp8_e4m3"),
                ops.wire_encode_many([a], codec_name="bf16_pack")[0][0],
                ops.wire_decode_accumulate(
                    *ops.wire_encode(a, codec_name="fp8_e4m3"), a,
                    codec_name="fp8_e4m3"),
                ops.wire_decode_accumulate(b, None, a,
                                           codec_name="bf16_pack"),
                ops.extract_segment(a, 0, 1, block=128),
                ops.merge_segments([a[:128], a[128:]], block=128)]
        q = torch.ones((2, 4, 8), device=dev)
        pool = torch.ones((3, 4, 2, 8), device=dev)
        tables = torch.zeros((2, 3), dtype=torch.int32, device=dev)
        valid = torch.ones(2, dtype=torch.int32, device=dev)
        outs.append(ops.paged_flash_decode(q, pool, pool, tables, valid))
        assert all(o.device.type == dev for o in outs)
        assert outs[-1].shape == (2, 4, 8)
        assert [o.shape[0] for o in outs[:6]] == [256] * 6
        assert set(plain) >= {"chunk_accumulate_ref", "fp8_encode_ref",
                              "fp8_decode_ref", "fp8_decode_accumulate_ref",
                              "bf16_pack_ref", "extract_segment_ref",
                              "merge_segments_ref",
                              "paged_flash_decode_ref"}
