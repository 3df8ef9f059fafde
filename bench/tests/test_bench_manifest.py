"""BENCHMARK.json against the contract's characters and shapes, and every
cell's files found by name."""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest

from bench import cells, compare, weights

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert any(w.startswith("bench/") for w in cmd)
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_units_and_text():
    every = (MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[kind]]
        assert len(names) == len(set(names)), kind
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert fours <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells_ = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m.get("workloads", cells_)) <= cells_
    for cell in cells_:
        got = {m["name"] for m in cells.metrics_for(cell, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert cells.metrics_for(cell, "per_layer")


def test_per_layer_layers_are_perf_md_layers():
    perf = (ROOT / "PERF.md").read_text()
    for m in MANIFEST["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    files = cells.load(cell)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert files["cell"]["name"] == cell
    assert files["cell"]["config"] == entry["config"]
    assert files["cell"]["traffic"] == entry["traffic"]
    assert files["cell"]["chips"] == entry["chips"]
    assert files["traffic"]["ranks"] == entry["chips"]
    assert hasattr(cells.driver(files["cell"]["driver"]), "run_cell")
    for m in cells.metrics_for(cell, "end_to_end") + \
            cells.metrics_for(cell, "per_layer"):
        assert callable(cells.reader(m["name"]).read)
    assert set(files["cell"]["limits"]) == set(compare.NUMBERS)


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_file_is_the_program_config(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("bench/")
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    widths = re.compile(r"_dim$|_rank$|^hidden_size$|^intermediate_size$|"
                        r"head_dim|expan|experts_per_tok|latent|state")
    assert not [k for k in config["reduced"] if widths.search(k)]
    for key in config["reduced"]:
        assert data[key] != data["published"][key]


CONFIG_FILES = sorted((BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_program_config_takes_the_file(path):
    """Every value of the file that names a field of the program's config
    is the value the program runs with."""
    data = json.loads(path.read_text())
    arch = cells.program_config(data)
    for key, field in cells.ARCH_KEYS.items():
        if key in data:
            assert getattr(arch, field) == data[key], key
    for key, field in cells.MOE_KEYS.items():
        if key in data:
            assert getattr(arch.moe, field) == data[key], key
    assert arch.head_dim_ == data["head_dim"]


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_weights_are_the_program_tree(path):
    from repro_torch.launch.steps import eval_shape_params
    data = json.loads(path.read_text())
    want = dict(weights.flatten(eval_shape_params(
        cells.program_config(data))))
    got = {p: s for p, s, _ in weights.leaf_specs(data)}
    assert set(got) == set(want)
    assert all(tuple(want[p].shape) == got[p] for p in got)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_and_no_program_in_the_reference():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path


def test_loaded_modules_hold_no_jax():
    """Every module the harness loads on the way to a run, in a fresh
    interpreter: no top-level name jax, jaxlib, flax or repro (compared
    whole: repro_torch is not repro)."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'bench')!r}, {str(ROOT)!r}, "
        f"{str(ROOT / 'src')!r}]\n"
        "import run, calibrate\n"
        "from bench import cells, faults, compare, trace, traffic\n"
        "from bench.drivers import train\n"
        "from bench.reference import model, adamw\n"
        "import repro_torch.launch.steps, repro_torch.launch.mesh\n"
        "for m in ('step_mfu_pct', 'offload_pct', 'k1_roofline_pct'):\n"
        "    cells.reader(m)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops


def test_run_without_a_card_exits_2_with_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         MANIFEST["workloads"][0]["name"], "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""


def test_unknown_cell_exits_2():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "no-such.cell",
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_run_length_fits_the_check():
    """A full check of 24 cells at this length fits its 43200 s."""
    assert len(MANIFEST["workloads"]) <= 24
    full = (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200
    assert full <= 43200
