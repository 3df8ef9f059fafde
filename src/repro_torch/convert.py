"""Parameter and optimizer-state carry-over from the JAX reference to the
port.

No counterpart in ``src/repro/``.  The reference's ``init_params`` tree,
with every leaf converted to a numpy array (``np.asarray``), becomes the
port's tree of tensors: the two trees share keys, shapes and the stacked
[L] layout, so the map is 1:1.  The reference's AdamW state
(``optim/adamw.py``'s ``AdamWState(step, mu, nu)``) maps the same way, so
a run resumed in the port starts where the reference stands.  numpy
bfloat16 arrays are ``ml_dtypes`` arrays, which ``torch.from_numpy``
rejects; they cross as their raw 16-bit patterns (``.view(np.uint16)``
then ``.view(torch.bfloat16)``), which is exact.

On a mesh the reference's ``shard_map`` hands each device its block of
every sharded leaf (``param_specs``); here ``shard_params`` cuts a rank's
block out of the global tree and ``gather_params`` puts the global tree
back together over one axis from every rank's along it, taking leaves
that axis does not shard from its rank 0, as ``np.asarray`` of the
reference's arrays does.  A leaf may be sharded on two dims: ep_a2a
experts over the expert-parallel span (the expert dim: the data axis, or
the outermost-major tuple ``("node", "data")`` / ``("pod", "node",
"data")`` on a cluster mesh, sliced at the rank's combined index over
the span) and the model axis (the FFN hidden dim).
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """One numpy array (float32, int or ml_dtypes bfloat16) -> tensor.
    The data is copied once (arrays from JAX are read-only)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree, device=None):
    """Nested dict of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def opt_state_from_reference(state, device=None):
    """The reference's ``AdamWState`` (leaves as numpy arrays) -> the
    port's; the step counter stays a scalar on the host."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=tensor_from_numpy(np.asarray(state.step)),
                      mu=params_from_reference(state.mu, device),
                      nu=params_from_reference(state.nu, device))


def spec_dim(spec, axis: str) -> int:
    """The dim a leaf's spec shards over ``axis``, or -1."""
    dims = [i for i, a in enumerate(spec) if a == axis]
    return dims[0] if dims else -1


def spec_axes(specs) -> set:
    """Every spec entry a spec tree shards some leaf over: mesh axis
    names, and the ep span's axis tuple where one shards the expert
    dim."""
    if isinstance(specs, dict):
        return set().union(*(spec_axes(v) for v in specs.values()))
    return {a for a in specs if a is not None}


def ep_sharded(specs, ctx) -> bool:
    """Whether the ep span of ``ctx`` (a ParallelCtx) shards a leaf of
    ``specs``: ep_a2a experts on a mesh whose ep span is wider than 1."""
    return ctx.ep_size > 1 and ctx.ep_spec_axis() in spec_axes(specs)


def respec_ep(specs, ep_axis):
    """``specs`` with every expert-dim entry (any entry but "model")
    replaced by ``ep_axis``: the specs of the same params on a mesh whose
    ep span is ``ep_axis`` (a rebuilt mesh after a node loss)."""
    if isinstance(specs, dict):
        return {k: respec_ep(v, ep_axis) for k, v in specs.items()}
    return tuple(a if a is None or a == "model" else ep_axis for a in specs)


def shard_params(tree, specs, tp_index: int, tp: int, *, ep_index: int = 0,
                 ep: int = 1):
    """One rank's local shards of a global tree (numpy arrays or
    tensors; a params tree, or an AdamW moment tree of the same layout),
    by the spec tree of ``transformer.param_specs``: dims sharded over
    "model" cut at ``(tp_index, tp)``, over the ep span (ep_a2a experts:
    "data" or an axis tuple) at ``(ep_index, ep)``, the rank's combined
    index over the span and its width.  Every leaf is a new contiguous
    array or tensor."""
    if isinstance(tree, dict):
        return {k: shard_params(v, specs[k], tp_index, tp, ep_index=ep_index,
                                ep=ep)
                for k, v in tree.items()}
    for d, axis in enumerate(specs):
        if axis is None:
            continue
        i, ways = (tp_index, tp) if axis == "model" else (ep_index, ep)
        if tree.shape[d] % ways:
            raise ValueError(f"dim {d} of {tuple(tree.shape)} does not "
                             f"divide over {ways} {axis} ranks")
        n = tree.shape[d] // ways
        tree = tree[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    if isinstance(tree, np.ndarray):
        return np.array(tree, order="C")
    return tree.clone(memory_format=torch.contiguous_format)


def gather_params(shards, specs, axis="model"):
    """The inverse of ``shard_params`` over ``axis`` (a spec entry: an
    axis name, or the ep span's tuple): ``shards`` are the local trees of
    ranks 0, 1, ... along it (of combined ep indices 0, 1, ... for the
    span); leaves it shards are concatenated along their dim, the others
    taken from its rank 0."""
    if isinstance(specs, dict):
        return {k: gather_params([s[k] for s in shards], v, axis)
                for k, v in specs.items()}
    d = spec_dim(specs, axis)
    if d < 0:
        return shards[0]
    if isinstance(shards[0], np.ndarray):
        return np.concatenate(shards, axis=d)
    return torch.cat(list(shards), dim=d)
