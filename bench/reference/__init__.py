"""The plain reference: float32 PyTorch, TF32 off, importing nothing of the
program under test (``model.py``, ``adamw.py``, ``train.py``).

A configuration's ``family`` names the module ``<family>.py`` here that
holds its layout, its loss, its keys and its CPU cut (the contract is in
``dense.py``): a new family is a new module, and nothing else here
changes."""

from __future__ import annotations

import importlib
import re
from typing import Dict

#: a family's name: a module name
FAMILY_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
#: what a family module provides
CONTRACT = ("leaf_specs", "loss", "PROGRAM_KEYS", "small")


def family(cfg: Dict):
    """The module of ``cfg["family"]``."""
    name = cfg["family"]
    if not FAMILY_RE.match(name):
        raise ValueError(f"family {name!r} is not a module name")
    mod = importlib.import_module(f"bench.reference.{name}")
    missing = [a for a in CONTRACT if not hasattr(mod, a)]
    if missing:
        raise ValueError(f"family {name!r}: bench/reference/{name}.py lacks "
                         f"{', '.join(missing)}")
    return mod
