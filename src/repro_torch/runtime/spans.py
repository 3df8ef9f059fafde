"""Spans and counters at the layer boundaries of the port's steps.

A span is a profiler range (``torch.profiler.record_function``), so a
trace taken with ``torch.profiler.profile`` holds it beside the host ops
and the device work they launch, on one clock.  Spans and counters are on
only while a profiler records (``torch.autograd._profiler_enabled()``);
otherwise :func:`span` returns one shared no-op object and :func:`count`
returns at once: no autograd node, no launch, no allocation.

A span that holds part of a differentiated region also names that
region's backward.  :meth:`Span.inputs` and :meth:`Span.outputs` put an
identity autograd Function on the region's inputs and outputs: in the
backward, the one at the outputs opens a range of the same name and the
one at the inputs closes it, both on autograd's thread.  Autograd runs
ready nodes by falling sequence number, so every node made inside the
region runs between the two.  Neither saves a tensor, so a
non-reentrant checkpoint sees the same saved tensors with tracing on
and off.  A checkpoint's recompute re-enters the forward code and so
lands in the forward spans by itself; :func:`recomputing` closes the
backward ranges open on its thread around it, so that the recompute is
not counted inside the backward span that happened to trigger it, and
opens them again after.

The profiler's trace keeps no ``record_function`` argument unless shapes
are recorded, so a span's arguments are part of its range's name, each
after one space: ``"route.staged 1048576"``.

Counters (:func:`count`) add up integers during profiled steps: host
ints on the host, device scalars on the device with no host sync.
Inside :func:`recomputing` nothing is counted, so a checkpointed layer
counts once a step.  :func:`counters` reads them all with one sync and
resets them.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

_enabled = torch.autograd._profiler_enabled

#: counter name -> host total / device total
_host: Dict[str, int] = {}
_device: Dict[str, torch.Tensor] = {}
#: per thread: ``recomputing`` depth, and the backward ranges it holds open
_local = threading.local()


def _open_ranges() -> List["_Box"]:
    stack = getattr(_local, "ranges", None)
    if stack is None:
        stack = _local.ranges = []
    return stack


class _Box:
    """The backward range of one forward span instance: opened by the
    output marker's backward, closed by the input marker's."""

    __slots__ = ("label", "rf")

    def __init__(self, label: str):
        self.label = label
        self.rf: Optional[record_function] = None

    def open(self) -> None:
        self.rf = record_function(self.label)
        self.rf.__enter__()
        _open_ranges().append(self)

    def close(self) -> None:
        if self.rf is None:
            return
        self.rf.__exit__(None, None, None)
        self.rf = None
        stack = _open_ranges()
        if self in stack:
            stack.remove(self)


class _OpenBackward(torch.autograd.Function):
    """Identity on a region's outputs; its backward opens the region's
    backward range."""

    @staticmethod
    def forward(ctx, box, *ys):
        ctx.box = box
        ctx.set_materialize_grads(False)
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *grads):
        ctx.box.open()
        return (None,) + grads


class _CloseBackward(torch.autograd.Function):
    """Identity on a region's inputs; its backward closes the region's
    backward range."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.box.close()
        return (None,) + grads


def _one_or_all(ts):
    return ts[0] if len(ts) == 1 else ts


class Span:
    """One open span (a profiler range while the ``with`` holds), and
    the markers that give its region's backward the same name."""

    __slots__ = ("label", "_rf", "_box")

    def __init__(self, label: str):
        self.label = label
        self._rf: Optional[record_function] = None
        self._box: Optional[_Box] = None

    def __enter__(self) -> "Span":
        self._rf = record_function(self.label)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)

    def inputs(self, *xs: torch.Tensor):
        """The region's inputs, marked: the backward range closes once
        their gradients are complete.  Returns them (one tensor alone).
        Marks nothing where autograd records nothing, and then the
        outputs are not marked either."""
        if not torch.is_grad_enabled() or not any(x.requires_grad
                                                   for x in xs):
            return _one_or_all(xs)
        self._box = _Box(self.label)
        return _one_or_all(_CloseBackward.apply(self._box, *xs))

    def outputs(self, *ys: torch.Tensor):
        """The region's outputs, marked: the backward range opens when
        their gradients reach the region.  Returns them (one alone)."""
        if self._box is None or not any(y.requires_grad for y in ys):
            return _one_or_all(ys)
        return _one_or_all(_OpenBackward.apply(self._box, *ys))


class _Off:
    """What :func:`span` gives while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def inputs(self, *xs):
        return _one_or_all(xs)

    outputs = inputs


_OFF = _Off()


def span(name: str, *args):
    """A context manager: the span ``name`` (its ``args`` after it in its
    range's name) while a profiler records; the shared no-op otherwise."""
    if not _enabled():
        return _OFF
    return Span(" ".join([name, *map(str, args)]))


def counting() -> bool:
    """Whether :func:`count` counts now: a profiler records and this
    thread is not in a checkpoint's recompute."""
    return _enabled() and not getattr(_local, "depth", 0)


def count(name: str, value) -> None:
    """Add ``value`` (a host int, or an integer device scalar) to the
    counter ``name`` while :func:`counting`."""
    if not counting():
        return
    if not torch.is_tensor(value):
        _host[name] = _host.get(name, 0) + int(value)
        return
    value = value.detach().reshape(())
    acc = _device.get(name)
    _device[name] = value if acc is None else acc + value


class recomputing:
    """The context of a checkpoint's recompute on this thread: nothing is
    counted, and the backward ranges open on the thread close on entry
    and open again, under the same names, on exit."""

    __slots__ = ("_paused",)

    def __enter__(self) -> "recomputing":
        _local.depth = getattr(_local, "depth", 0) + 1
        self._paused = []
        if _enabled():
            stack = _open_ranges()
            self._paused = list(stack)
            for box in reversed(self._paused):
                box.close()
        return self

    def __exit__(self, *exc) -> None:
        _local.depth -= 1
        for box in self._paused:
            box.open()


def counters() -> Dict[str, int]:
    """Every counter's total since the last read (one sync for the device
    ones); resets them all."""
    out = dict(_host)
    if _device:
        names = list(_device)
        vals = torch.stack([_device[n].long() for n in names]).tolist()
        for n, v in zip(names, vals):
            out[n] = out.get(n, 0) + int(v)
    _host.clear()
    _device.clear()
    return out
