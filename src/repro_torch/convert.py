"""Parameter and optimizer-state carry-over from the JAX reference to the
port.

No counterpart in ``src/repro/``.  The reference's ``init_params`` tree,
with every leaf converted to a numpy array (``np.asarray``), becomes the
port's tree of tensors: the two trees share keys, shapes and the stacked
[L] layout, so the map is 1:1.  The reference's AdamW state
(``optim/adamw.py``'s ``AdamWState(step, mu, nu)``) maps the same way, so
a run resumed in the port starts where the reference stands.  numpy bfloat16 arrays are ``ml_dtypes``
arrays, which ``torch.from_numpy`` rejects; they cross as their raw 16-bit
patterns (``.view(np.uint16)`` then ``.view(torch.bfloat16)``), which is
exact.
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
