"""The port's one tracing system: spans at its layer boundaries and
process-wide counters.

``span(name, **counts)`` marks a phase of the program (a frame, a fit step,
a spp chunk, a kernel route's forward or backward, a collective; the names
are listed in PERF.md section 3).  Tracing is on while a ``torch.profiler``
profile records (torch's own query, ``torch.autograd._profiler_enabled``:
so ``port_bench``'s ``--trace 1`` runs and the CLI's ``--trace`` turn it
on) or between ``enable()`` and ``disable()``; the end-to-end runs leave it
off.

* Off, ``span`` tests a flag and returns one shared no-op object: no
  record, no CUDA call, no ``record_function``.
* On, a span enters ``torch.profiler.record_function(name)``, so the phase
  lands in the profiler's trace beside the kernels; where CUDA is in use it
  records a pair of timing events on the current stream (none on the CPU,
  whose work runs synchronously: there the device time is the host time);
  and it appends a record.  It never synchronises.

A record (one dict of ``spans()``):

* ``name``, ``id``;
* ``parent``: the innermost span open on the thread; on a thread with none
  open (autograd's backward thread), the span that called ``backward()``,
  which is the latest opened span still open;
* ``request``: the id of the outermost span of the chain (the frame, fit
  step or CLI phase that opened it);
* ``start_ns`` / ``end_ns``: host time on the profiler's clock, Unix
  nanoseconds (a ``trace.json`` event's ``ts`` is in microseconds after the
  file's ``baseTimeNanoseconds``);
* ``device_ms``: between the span's two CUDA events (host time on the CPU),
  resolved only when ``spans()`` reads the records; None while it is open;
* ``counts``: the span's counts, and what ``add`` gave it.  ``add`` keeps a
  tensor by reference and sums it only in ``spans()`` (under a tuple of
  names, entry i of the tensor sums into name i), so a traced step
  launches exactly the kernels an untraced one does.

A new period of tracing clears the last period's records; at most
``MAX_RECORDS`` are kept, each span beyond counts ``tracing.dropped``.

``count(name, n)`` keeps process-wide integer counters, always on:
``launch.<kernel>[.<variant>]`` for each launch of a CUDA kernel (and
``launch.<kernel>[.<variant>].emit`` beside it for the launches of an
emissive scene), ``plain.<function>`` for each call of a plain version, and
``shard.reduce_bytes``.  ``counts()`` returns a copy.  The state is the
process's, by design: it spans every caller, as the profiler does.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter

import torch

# Records kept per period of tracing.
MAX_RECORDS = 1 << 16

_profiling = torch.autograd._profiler_enabled

_enabled = False      # between enable() and disable()
_seen_on = False      # the last span() found tracing on
_records: list = []
_open: list = []      # open records of every thread, in the order they opened
_local = threading.local()
_ids = itertools.count(1)
_counts: Counter = Counter()
_lock = threading.Lock()


class _Record:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "events",
                 "device_ms", "counts", "pending")

    def __init__(self, name, parent, counts):
        self.name = name
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.request = self.id if parent is None else parent.request
        self.start_ns = self.end_ns = self.device_ms = None
        self.events = None
        self.counts = counts
        self.pending = None

    def add(self, name, value):
        if isinstance(value, torch.Tensor):
            if self.pending is None:
                self.pending = {}
            self.pending.setdefault(name, []).append(value)
        else:
            self.counts[name] = self.counts.get(name, 0) + value

    def resolve(self) -> dict:
        if self.end_ns is not None:
            if self.pending:
                for key, ts in self.pending.items():
                    names = key if isinstance(key, tuple) else (key,)
                    total = sum(t.to(torch.float64).reshape(len(names), -1).sum(1) for t in ts)
                    for name, v in zip(names, total.tolist()):
                        self.counts[name] = self.counts.get(name, 0) + round(v)
                self.pending = None
            if self.device_ms is None:
                if self.events is None:
                    self.device_ms = (self.end_ns - self.start_ns) * 1e-6
                else:
                    a, b = self.events
                    b.synchronize()
                    self.device_ms = a.elapsed_time(b)
                    self.events = None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": self.device_ms, "counts": dict(self.counts)}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("_name", "_counts", "_rec", "_rf")

    def __init__(self, name, counts):
        self._name, self._counts = name, counts

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        stack = _stack()
        parent = stack[-1] if stack else (_open[-1] if _open else None)
        rec = self._rec = _Record(self._name, parent, self._counts)
        if len(_records) < MAX_RECORDS:
            _records.append(rec)
            if torch.cuda.is_initialized():
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                rec.events[0].record()
        else:
            count("tracing.dropped")
        rec.start_ns = time.time_ns()
        stack.append(rec)
        _open.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record()
        _stack().pop()
        _open.remove(rec)
        self._rf.__exit__(*exc)
        return False

    def add(self, name, value):
        """Add ``value`` (a number, or a tensor summed when read) to the
        span's count ``name`` (a tuple of names: the tensor's entries, one
        each)."""
        self._rec.add(name, value)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, name, value):
        pass


_NOOP = _NoSpan()


def span(name: str, **counts):
    """A context manager marking the phase ``name`` (see the module's
    docstring); ``counts`` start the record's counts."""
    global _seen_on
    if not (_enabled or _profiling()):
        _seen_on = False
        return _NOOP
    if not _seen_on:
        _seen_on = True
        _records.clear()
    return _Span(name, counts)


def add(name, value) -> None:
    """Add ``value`` to the count ``name`` (or tuple of names, as
    ``_Span.add``) of the thread's innermost open span; nothing while
    tracing is off (no span is open then)."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].add(name, value)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    with _lock:
        _counts[name] += n


def counts() -> Counter:
    """A copy of the process-wide counters (a missing name reads 0)."""
    with _lock:
        return Counter(_counts)


def spans() -> list:
    """The records of the last period in which tracing was on, in the order
    their spans opened, device times and tensor counts resolved (this
    waits for the device work they cover)."""
    return [rec.resolve() for rec in list(_records)]


def enable() -> None:
    """Turn tracing on and start a new period."""
    global _enabled, _seen_on
    _records.clear()
    _enabled = _seen_on = True


def disable() -> None:
    """Turn ``enable()`` off; a profiler still recording keeps the period
    going, else the next span that finds tracing on starts a new one."""
    global _enabled, _seen_on
    _enabled = False
    _seen_on = _profiling()


@contextlib.contextmanager
def enabled():
    """Tracing on for the block, in a new period."""
    enable()
    try:
        yield
    finally:
        disable()
