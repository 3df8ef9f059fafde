"""Checkpointing: flat-keyed .npz checkpoints with step metadata, atomic
writes, retention, and exact tree-structure restore (params + optimizer
state).

Port of ``src/repro/checkpoint/checkpointer.py`` with the same file
layout: one ``ckpt_<step:08d>.npz`` per snapshot whose keys are the
tree's paths joined by ``/`` (``params/layers/attn/wq``,
``opt/mu/embed``, ``opt/step``), bf16 leaves stored as their uint16 bit
patterns under ``<key>@bf16``, and a JSON ``__meta__`` entry.  The
error-feedback opt state ``(AdamWState, residuals)`` of a bucketed run
under a lossy codec takes the reference's tuple keys (``opt/0/mu/...``,
``opt/1/...``).  A checkpoint written by either package restores in the
other.

On a model axis (a ctx with tp > 1, and the ``param_specs`` tree) every
rank holds local shards, and the file still holds the reference's GLOBAL
layout: ``save`` is collective over the rank's model line, which
all-gathers each sharded leaf of the params, the AdamW moments and the
error-feedback residuals (param-shaped, sharded like the params), and
model rank 0 writes.  ep_a2a experts are sharded over the ep span too
(the data axis, or (pod, node, data) on a cluster mesh): then ``save`` is
collective over every rank, gathers those leaves over the span (its
plane group, in combined-index order) after the model axis, and only the
rank at index 0 of every axis writes.  Replicated leaves are model rank
0's own copy (ep index 0's when the span shards leaves), which is what
the reference's ``np.asarray``
of a leaf whose per-device copies differ saves.  ``restore`` reads the global file on every rank and cuts
the rank's shard (convert.py), so every rank gets the same replicated
copy, as the reference's ``device_put`` gives.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import (ep_sharded, gather_params, shard_params,
                                 spec_dim)

_SEP = "/"


def _to_numpy(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(key suffix, array): bfloat16 as its uint16 bit patterns (npz has
    no bf16), everything else as it is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return "@bf16", t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif hasattr(tree, "_fields"):  # NamedTuple — must precede tuple check
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        key = prefix[:-1] if prefix.endswith(_SEP) else prefix
        suffix, arr = _to_numpy(torch.as_tensor(tree))
        out[key + suffix] = arr
    return out


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{k}{_SEP}")
                for k in template}
    if isinstance(template, (tuple, list)) and not hasattr(template,
                                                           "_fields"):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}{_SEP}")
                for i, v in enumerate(template)]
        return type(template)(vals)
    if hasattr(template, "_fields"):
        vals = {k: _unflatten_into(getattr(template, k), flat,
                                   f"{prefix}{k}{_SEP}")
                for k in template._fields}
        return type(template)(**vals)
    key = prefix[:-1] if prefix.endswith(_SEP) else prefix
    if key + "@bf16" in flat:
        arr = torch.from_numpy(np.array(flat[key + "@bf16"], order="C")
                               .view(np.int16)).view(torch.bfloat16)
    else:
        arr = torch.from_numpy(np.array(flat[key], order="C"))
    want = torch.as_tensor(template)
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {tuple(arr.shape)}, "
                         f"the template has {tuple(want.shape)}")
    return arr.to(device=want.device, dtype=want.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, *, ctx=None,
                 specs=None):
        """``ctx`` with a model axis wider than 1, or an ep span wider
        than 1 that ``specs`` (the ``transformer.param_specs`` tree)
        shards ep_a2a experts over, makes the params and moments
        rank-local shards; every rank of the model line (of the mesh,
        when the ep span shards leaves) must then call ``save``.  Only the
        rank of pod 0, node 0, data row 0 and model rank 0 writes."""
        self.dir = directory
        self.keep = keep
        #: the ep span's spec entry when it shards leaves (ep_a2a
        #: experts), else None
        self.ep = (ctx.ep_spec_axis() if ctx is not None
                   and specs is not None and ep_sharded(specs, ctx)
                   else None)
        self.ctx = ctx if ctx is not None and (ctx.tp_size > 1
                                               or self.ep) else None
        if self.ctx is not None and specs is None:
            raise ValueError("Checkpointer: a model axis needs the param "
                             "specs")
        self.specs = specs
        self.writer = ctx is None or (
            ctx.pod_index() == 0 and ctx.node_index() == 0
            and ctx.dp_index() == 0 and ctx.tp_index() == 0)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        if self.ctx is not None:
            params = self._gather(params, self.specs)
            if opt_state is not None:
                opt_state = self._gather_opt(opt_state)
            if not self.writer:
                return self._path(step)
        tree = {"params": params}
        if opt_state is not None:
            tree["opt"] = opt_state
        flat = _flatten(tree)
        meta = {"step": step, "extra": extra or {}}
        path = self._path(step)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __meta__=json.dumps(meta), **flat)
            shutil.move(tmp, path)          # atomic within the same fs
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self._gc()
        return path

    def _gather(self, tree, specs):
        """The global tree (collective over the model line, and over the
        ep span when it shards leaves)."""
        if isinstance(specs, dict):
            return {k: self._gather(tree[k], specs[k]) for k in tree}
        axes = [("model", self.ctx.tp_axis)] if self.ctx.tp_size > 1 else []
        axes += [(self.ep, self.ep)] if self.ep else []
        for name, axis in axes:
            if spec_dim(specs, name) >= 0:
                g = self.ctx.mesh.all_gather(tree.contiguous(), axis)
                tree = gather_params(list(g), specs, name)
        return tree

    def _gather_opt(self, opt_state):
        """The global AdamW state, or ``(AdamWState, residuals)``."""
        if isinstance(opt_state, tuple) and not hasattr(opt_state,
                                                        "_fields"):
            state, residuals = opt_state
            return (self._gather_opt(state),
                    self._gather(residuals, self.specs))
        return opt_state._replace(mu=self._gather(opt_state.mu, self.specs),
                                  nu=self._gather(opt_state.nu, self.specs))

    #: key prefixes of the param-shaped trees of a file: the params, the
    #: moments (bare AdamWState, or the first of the error-feedback pair)
    #: and the residuals
    _PARAM_SHAPED = (("params",), ("opt", "mu"), ("opt", "nu"),
                     ("opt", "0", "mu"), ("opt", "0", "nu"), ("opt", "1"))

    def _shard_flat(self, flat: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """This rank's shards of the global param-shaped trees of a
        file."""
        out = {}
        for key, arr in flat.items():
            path = key.removesuffix("@bf16").split(_SEP)
            head = next((h for h in self._PARAM_SHAPED
                         if tuple(path[:len(h)]) == h), None)
            if head is None:
                out[key] = arr
                continue
            path = path[len(head):]
            spec = self.specs
            for part in path:
                spec = spec[part]
            out[key] = shard_params(
                arr, spec, self.ctx.tp_index(), self.ctx.tp_size,
                ep_index=self.ctx.ep_index() if self.ep else 0,
                ep=self.ctx.ep_size if self.ep else 1)
        return out

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            os.remove(self._path(s))

    def all_steps(self):
        out = []
        for f in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_template, opt_template=None,
                step: Optional[int] = None) -> Tuple[Any, Any, Dict]:
        """New tensors shaped, typed and placed like the templates' (on a
        model axis, the rank's local shards)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._path(step), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(str(z["__meta__"]))
        if self.ctx is not None:
            flat = self._shard_flat(flat)
        params = _unflatten_into(params_template, flat, "params" + _SEP)
        opt = None
        if opt_template is not None:
            opt = _unflatten_into(opt_template, flat, "opt" + _SEP)
        return params, opt, meta

    def restore_latest(self, params_template, opt_template=None
                       ) -> Tuple[Any, Any, Dict, int]:
        """The newest snapshot and its step: :meth:`restore` with
        ``step=None``, plus the step the snapshot's meta records (the
        reference's ``Checkpointer.restore_latest``, checkpointer.py:128).
        Raises FileNotFoundError when the directory holds none."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        params, opt, meta = self.restore(params_template, opt_template,
                                         step)
        return params, opt, meta, int(meta.get("step", step))
