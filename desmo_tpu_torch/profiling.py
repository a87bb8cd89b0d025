"""Spans and counters of the program's own layers: the fit loops, the
mega-kernel's wrapper and the checkpoint worker. The role of
``desmo_tpu/profiling.py``, on ``torch.profiler``.

* :func:`span` ``(name)``: a context manager. While tracing is on it records
  the span's name, start and end (``time.perf_counter()``), thread and parent
  span, and opens a ``torch.profiler.record_function`` range of the same name,
  so the span shows in any Chrome trace. While off it is one flag check and
  allocates nothing.
* :func:`count` ``(name, n=1)``: adds to a counter, always (they count rare
  events: rollbacks, frozen seeds, checkpoint writes, hand-offs that waited
  on the previous write).
* :func:`kernel_clock`: after a mega-kernel launch, while tracing is on, a
  non-blocking copy of the launch's kernel clock from its workspace into a
  pinned buffer allocated once; the values are read at the next launch or at
  :func:`records`, after the fit's metrics fetch has synchronized, and kept
  on the launch's ``chunk.enqueue`` record.

Tracing is on while :func:`enable` is in force and while a
``torch.profiler`` session is active (``torch.autograd.profiler.
_is_profiler_enabled``), so a traced run gets the program's spans with no
change to its caller. :func:`records`, :func:`counters` and :func:`reset`
read and clear what was kept; ``counters()`` also reports the kernels'
``launches`` attributes.

The spans (one tree on the fit's thread, parents by id):

``fit``: a ``train.fit`` or ``ensemble.fit`` call; its children
``fit.launch`` (the chunk call; inside it ``chunk.pack``, ``chunk.enqueue``
and ``chunk.unpack`` from ``kernels.train_chunk``), ``fit.fetch`` (metrics to
the host, the finite check, the history), ``fit.log`` (a boundary's lines),
``fit.checkpoint`` (the gather, the host copy, the wait on the previous
write and the hand-off; in ``ensemble.fit`` the best live seed's state
first), ``fit.init`` and ``fit.snapshot``
(``ensemble.fit``'s group init and rollback snapshot), ``fit.rollback`` and
``fit.drain`` (the wait on the last write). On the checkpoint worker,
``ckpt.write``, whose parent is the ``fit.checkpoint`` that handed it over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_enabled = 0  # nesting depth of enable()
_lock = threading.Lock()
_records: list = []
_counters: dict = {}
_local = threading.local()  # .stack: the records of the spans open on this thread
_clock_buffers: dict = {}  # (device, size) -> pinned host buffer
_clock_pending: Optional[tuple] = None  # (record, names, buffer, event)


@dataclasses.dataclass
class Record:
    """One span: ``id`` is its index in :func:`records`; ``parent`` the id of
    the span it opened in, or None; on a launch's ``chunk.enqueue``,
    ``clock`` the launch's kernel clock (ns by phase name) and ``launched``
    the ``perf_counter`` time just before the launch call."""

    id: int
    name: str
    start: float
    end: Optional[float]
    thread: int
    parent: Optional[int]
    clock: Optional[dict] = None
    launched: Optional[float] = None


def tracing() -> bool:
    """Whether spans are recorded now."""
    return bool(_enabled) or _autograd_profiler._is_profiler_enabled


class enable:
    """Tracing on while in force: ``with profiling.enable(): ...``, or
    ``enable()`` then ``disable()``."""

    def __init__(self):
        global _enabled
        _enabled += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        disable()


def disable() -> None:
    global _enabled
    _enabled = max(0, _enabled - 1)


_NULL = contextlib.nullcontext()  # what every span is while tracing is off


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Optional[int]:
    """The id of the innermost span open on this thread, or None: hand it to
    a worker's :func:`span` as its ``parent``."""
    stack = _stack()
    return stack[-1].id if stack else None


class _Span:
    __slots__ = ("name", "parent", "record", "range")

    def __init__(self, name: str, parent: Optional[int]):
        self.name, self.parent = name, parent

    def __enter__(self):
        stack = _stack()
        parent = self.parent if self.parent is not None else (stack[-1].id if stack else None)
        start = time.perf_counter()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        with _lock:
            rec = Record(len(_records), self.name, start, None, threading.get_ident(), parent)
            _records.append(rec)
        stack.append(rec)
        self.record = rec
        return rec

    def __exit__(self, *exc):
        # both clock reads come before the range's op calls, as the
        # profiler's own stamps do inside them
        self.record.end = time.perf_counter()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, parent: Optional[int] = None):
    """A span named ``name``, in the innermost span open on this thread or,
    given, in span ``parent`` (a worker's span in the caller's)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, parent)


def traced(name: str):
    """Decorator: the whole call is one span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def kernel_clock(src: torch.Tensor, names, launched: Optional[float] = None) -> None:
    """While tracing is on, copy a launch's kernel clock (``src``: the
    workspace's ``2 len(names)`` float32 words holding as many int64 ns
    counters) without blocking into a buffer allocated once, and keep it,
    with the time of the launch call (``launched``), for the innermost open
    span (the launch's ``chunk.enqueue``). The previous launch's values are
    read first: the fit's metrics fetch has synchronized since, so the read
    waits on nothing there."""
    global _clock_pending
    if not tracing():
        return
    stack = _stack()
    if not stack:
        return
    _read_clock()
    stack[-1].launched = launched
    key = (src.device, src.numel())
    buf = _clock_buffers.get(key)
    if buf is None:
        buf = _clock_buffers[key] = torch.empty(src.numel(), dtype=src.dtype,
                                                pin_memory=src.device.type == "cuda")
    buf.copy_(src, non_blocking=True)
    event = None
    if src.device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    _clock_pending = (stack[-1], tuple(names), buf, event)


def _read_clock() -> None:
    global _clock_pending
    if _clock_pending is None:
        return
    rec, names, buf, event = _clock_pending
    _clock_pending = None
    if event is not None:
        event.synchronize()
    ns = buf.view(torch.int64).tolist()
    rec.clock = dict(zip(names, ns))


def records() -> list:
    """The spans recorded since the last :func:`reset`, in the order they
    opened (``Record``; ``end`` None while open)."""
    _read_clock()
    with _lock:
        return list(_records)


def counters() -> dict:
    """The counters, and the kernels' launches (``<kernel>.launches``, read
    from the wrappers' own attributes)."""
    from desmo_tpu_torch.kernels import ae_chunk, dual_gemm, shard_step, train_chunk

    with _lock:
        out = dict(_counters)
    for fn in (train_chunk.fused_train_chunk, train_chunk.fused_ensemble_chunk, train_chunk.contract_probe,
               ae_chunk.fused_ae_chunk, dual_gemm.dual_contractions, shard_step.step):
        out[f"{fn.__name__}.launches"] = int(fn.launches)
    return out


def reset() -> None:
    """Forget the spans and the counters (the kernels' launches stay)."""
    global _clock_pending
    with _lock:
        _records.clear()
        _counters.clear()
    _clock_pending = None


def as_json() -> dict:
    """The spans and counters as plain JSON values (``run --profile``'s
    ``spans.json``)."""
    return {"records": [dataclasses.asdict(r) for r in records()], "counters": counters()}
