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

On a model axis the reference's ``shard_map`` hands each device its
block of every sharded leaf (``param_specs``); here ``shard_params`` cuts
a rank's block out of the global tree and ``gather_params`` puts the
global tree back together from every model rank's, taking replicated
leaves from model rank 0, as ``np.asarray`` of the reference's arrays
does.
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


def sharded_dim(spec) -> int:
    """The dim a leaf's spec shards over the model axis, or -1."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    if len(dims) > 1:
        raise ValueError(f"spec {spec}: more than one sharded dim")
    return dims[0] if dims else -1


def shard_params(tree, specs, tp_index: int, tp: int):
    """One model rank's local shards of a global tree (numpy arrays or
    tensors; a params tree, or an AdamW moment tree of the same layout),
    by the spec tree of ``transformer.param_specs``.  Every leaf is a new
    contiguous array or tensor."""
    if isinstance(tree, dict):
        return {k: shard_params(v, specs[k], tp_index, tp)
                for k, v in tree.items()}
    d = sharded_dim(specs)
    if d >= 0:
        if tree.shape[d] % tp:
            raise ValueError(f"dim {d} of {tuple(tree.shape)} does not "
                             f"divide over {tp} model ranks")
        n = tree.shape[d] // tp
        tree = tree[(slice(None),) * d + (slice(tp_index * n,
                                                (tp_index + 1) * n),)]
    if isinstance(tree, np.ndarray):
        return np.array(tree, order="C")
    return tree.clone(memory_format=torch.contiguous_format)


def gather_params(shards, specs):
    """The inverse of ``shard_params`` over the model axis: ``shards`` are
    the local trees of model ranks 0, 1, ...; sharded leaves are
    concatenated along their dim, replicated leaves taken from rank 0."""
    if isinstance(specs, dict):
        return {k: gather_params([s[k] for s in shards], v)
                for k, v in specs.items()}
    d = sharded_dim(specs)
    if d < 0:
        return shards[0]
    if isinstance(shards[0], np.ndarray):
        return np.concatenate(shards, axis=d)
    return torch.cat(list(shards), dim=d)
