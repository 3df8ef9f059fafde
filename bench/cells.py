"""Find a cell's files by name and turn its configuration into the
program's.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and its driver (``drivers/<driver>.py``); ``BENCHMARK.json`` at the root
of the checkout lists the metrics, each read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import re
import sys
from typing import Any, Dict, List

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

#: the characters of a name in BENCHMARK.json
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")

#: configuration key -> ArchConfig field (MoE keys: MoEConfig fields)
ARCH_KEYS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
             "sliding_window": "sliding_window",
             "attention_bias": "qkv_bias",
             "tie_word_embeddings": "tie_embeddings",
             "torch_dtype": "param_dtype"}
MOE_KEYS = {"num_local_experts": "n_experts", "num_experts_per_tok": "top_k",
            "capacity_factor": "capacity_factor",
            "router_aux_loss_coef": "aux_loss_weight"}


#: top-level module names no run may hold: the JAX stack and the JAX
#: package (``repro_torch`` is not ``repro``: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names this process has imported."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _by_name(kind: str, name: str) -> Dict[str, Any]:
    if not NAME_RE.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = BENCH / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return _json(path)


def manifest() -> Dict[str, Any]:
    """``BENCHMARK.json`` of the checkout."""
    return _json(ROOT / "BENCHMARK.json")


def load(cell: str) -> Dict[str, Dict[str, Any]]:
    """The cell's own file, its configuration and its traffic mix."""
    spec = _by_name("workloads", cell)
    return {"cell": spec, "config": _by_name("configs", spec["config"]),
            "traffic": _by_name("traffic", spec["traffic"])}


def metrics_for(cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics of
    BENCHMARK.json that the cell reports: those without a ``workloads``
    list, and those whose list names it."""
    return [m for m in manifest()[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """``metrics/<metric>.py``: its ``read(run)``."""
    if not NAME_RE.match(metric):
        raise ValueError(f"metric name {metric!r}")
    return importlib.import_module(f"bench.metrics.{metric}")


def driver(name: str):
    if not NAME_RE.match(name):
        raise ValueError(f"driver name {name!r}")
    return importlib.import_module(f"bench.drivers.{name}")


def program_config(cfg: Dict[str, Any]):
    """The program's ArchConfig of a configuration file: the program's
    own config of ``program_arch`` with every value of the file that names
    one of its fields (``ARCH_KEYS``, ``MOE_KEYS``, ``head_dim``) put in."""
    from repro_torch.configs import get_config
    arch = get_config(cfg["program_arch"])
    fields = {f: cfg[k] for k, f in ARCH_KEYS.items() if k in cfg}
    if arch.moe is not None:
        moe = {f: cfg[k] for k, f in MOE_KEYS.items() if k in cfg}
        fields["moe"] = dataclasses.replace(arch.moe, **moe)
    out = dataclasses.replace(arch, head_dim=0, **fields)
    if out.head_dim_ != cfg["head_dim"]:
        out = dataclasses.replace(out, head_dim=cfg["head_dim"])
    out.validate()
    return out

