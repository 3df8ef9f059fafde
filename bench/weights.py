"""Weights from the seed, made on the device in the type they are trained
in, in the parameter tree the program takes.

The tree is the one ``repro_torch``'s train step takes, as the
configuration's family lays it out (``bench/reference/<family>.py``,
stacked ``[L, ...]`` layers): each matrix is drawn from
N(0, 0.02^2) in one ``torch.randn`` on a generator of the device, each
norm is ones.  Leaves are drawn in the family's order (sorted by path in
``dense`` and ``moe``), one call a leaf, so
:func:`leaves` can draw them again one at a time with the same bits.
Both the program and the reference are handed these weights.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch

from bench import reference

#: the standard deviation of every drawn matrix
INIT_STD = 0.02

Path = Tuple[str, ...]


def derive(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_specs(cfg: Dict) -> List[Tuple[Path, Tuple[int, ...], str]]:
    """(path, shape, "normal" | "ones" | "zeros") of every leaf, in the
    order they are drawn: the family's (``bench/reference/<family>.py``)."""
    v = cfg["vocab_size"]
    if v % 256:
        raise ValueError(f"vocab_size {v}: the program pads the vocabulary "
                         f"to a multiple of 256")
    return reference.family(cfg).leaf_specs(cfg)


def leaves(cfg: Dict, seed: int, device, dtype=None
           ) -> Iterator[Tuple[Path, torch.Tensor]]:
    """Every leaf of the tree, drawn in order, one at a time."""
    dtype = dtype or getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    for path, shape, kind in leaf_specs(cfg):
        if kind == "normal":
            x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            x.mul_(INIT_STD)
        elif kind == "ones":
            x = torch.ones(shape, dtype=dtype, device=device)
        else:
            x = torch.zeros(shape, dtype=dtype, device=device)
        yield path, x


def nest(pairs) -> Dict:
    """(path, value) pairs as a nested dict."""
    tree: Dict = {}
    for path, x in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def flatten(tree, path: Path = ()) -> List[Tuple[Path, object]]:
    """A nested dict's leaves, in sorted path order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten(tree[k], path + (k,))]
    return [(path, tree)]


def make(cfg: Dict, seed: int, device, dtype=None) -> Dict:
    """The whole tree on ``device``."""
    return nest(leaves(cfg, seed, device, dtype))


def layout_errors(tree, reference_tree) -> List[str]:
    """Where ``tree`` differs in paths, shapes or dtypes from the tree
    the program builds (``reference_tree``, meta tensors will do)."""
    got = {p: (tuple(x.shape), x.dtype) for p, x in flatten(tree)}
    want = {p: (tuple(x.shape), x.dtype) for p, x in flatten(reference_tree)}
    errs = [f"{'/'.join(p)}: missing" for p in want if p not in got]
    errs += [f"{'/'.join(p)}: not in the program's tree" for p in got
             if p not in want]
    errs += [f"{'/'.join(p)}: {got[p]} != {want[p]}" for p in want
             if p in got and got[p] != want[p]]
    return errs
