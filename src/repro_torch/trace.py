"""Spans and counters inside the program.

Spans name the program's phases in a ``torch.profiler`` trace; counters
accumulate on the running batch's
:class:`~repro_torch.vectordb.planner.BatchAccounting`.

* **Spans** are a no-op unless a ``torch.profiler`` session is recording:
  :func:`span` then returns one shared do-nothing context, and no
  ``record_function`` is made. While a session records, a span is a
  ``record_function``, so it lands in the profiler's own event stream on the
  device trace's clock and the Chrome trace is the export. No environment
  variable or setting turns spans on or off.
* **Counters** are always on: clock reads and integer adds on the
  accounting that :func:`counting` makes current for this thread. Outside a
  batch (a direct ``dsq`` call) there is none, and nothing is counted.

Span catalog (each name at most 12 characters; the leaf phases ``rank.*``
sort before the ``sched.*`` ones, so that both survive a label of every
open span's name, sorted and cut to 64 characters):

================ ============================================================
``sched.form``   the collector forms a batch (``_form_batch``)
``sched.stage``  the staging pass of a formed batch (``_do_stage``)
``sched.exec``   the execute function of one batch
``sched.done``   the accounting stamp, ``record_batch`` and the tickets
``sched.maint``  the between-batches maintenance hook, when it runs
``db.plan``      ``dsq_batch``: normalise the specs and plan the groups
``db.rank``      ``dsq_batch``: the executor launches
``db.finish``    ``dsq_batch``: byte terms, placement, per-request results
``rank.put``     executor: host preparation and host->device copies
``rank.run``     executor: row gathers, kernel calls, id remapping
``rank.get``     executor: the copies back to the host
``rank.approx``  quantized executor call: phase 1 of the two-phase plan, the
                 query quantisation or LUT, its uploads, the int8 / PQ scan
                 or gather (kernels 5-8) and the copy back of the candidates
``rank.rescore`` ``gather_rescore``: the exact fp32 rescore (phase 2)
================ ============================================================

The three phases ``rank.put``, ``rank.run`` and ``rank.get`` tile each
executor call (:class:`Tiles`). The flat launch of ``dsq_batch`` runs inside
one more ``Tiles``, in ``rank.run`` without spans (``db.rank`` names it),
which counts the batch's own dispatch between executor calls. The counters are ``rank_host_ns``
(``rank.put`` + ``rank.run``), ``rank_wait_ns`` (``rank.get``: a copy back
blocks until the device work queued before it has finished) and
``rank_syncs`` (copies back).

The two phases of a quantized plan are regions (:class:`Region`) around
those tiles: ``rank.approx`` adds its host time, its wait for the candidates
included, to ``approx_ns``, and ``rank.rescore`` to ``rescore_ns``. Both lie
inside ``rank_host_ns + rank_wait_ns`` and leave those as they were. The
benchmark reads them as ``bench/metrics/approx_ms.py`` and ``rescore_ms.py``
(and ``BatchAccounting.gather_alone``, the gather groups ranked one executor
call each, as ``gather_alone.py``).
"""
from __future__ import annotations

import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "recording", "counting", "current", "Tiles", "Region",
           "approx", "rescore", "PUT", "RUN", "GET", "APPROX", "RESCORE"]

PUT, RUN, GET = "rank.put", "rank.run", "rank.get"
APPROX, RESCORE = "rank.approx", "rank.rescore"


def recording() -> bool:
    """True while a ``torch.profiler`` session records, on any thread (the
    profiler's own process-wide flag; the C++ one is per thread)."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The shared do-nothing span."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else the shared
    do-nothing context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


_local = threading.local()


def current():
    """This thread's current batch accounting, or None outside a batch."""
    return getattr(_local, "acct", None)


class counting:
    """Make ``acct`` this thread's current accounting for the block (and
    restore the one before it on exit)."""
    __slots__ = ("acct", "_prev")

    def __init__(self, acct):
        self.acct = acct

    def __enter__(self):
        self._prev = getattr(_local, "acct", None)
        _local.acct = self.acct
        return self.acct

    def __exit__(self, *exc):
        _local.acct = self._prev
        return False


class Tiles:
    """Consecutive phases of one executor call, from ``first`` on:
    :meth:`to` ends the phase before it and starts the next, the exit ends
    the last. Each phase adds its nanoseconds to the current accounting's
    ``rank_wait_ns`` (``rank.get``) or ``rank_host_ns`` (the others) and,
    with ``spans``, is a span while a profiler records. A ``Tiles`` entered
    while another is open on this thread pauses that one until its exit,
    so time counts once, in the innermost phase."""
    __slots__ = ("_first", "_spans", "_acct", "_name", "_t", "_rf",
                 "_outer")

    def __init__(self, first: str = PUT, spans: bool = True):
        self._first = first
        self._spans = spans

    def __enter__(self) -> "Tiles":
        t = time.perf_counter_ns()
        self._acct = current()
        self._outer = getattr(_local, "tiles", None)
        if self._outer is not None:
            self._outer._stop(t)
        _local.tiles = self
        self._rf = None
        self._start(self._first, t)
        return self

    def to(self, name: str) -> None:
        if name == self._name:
            return
        t = time.perf_counter_ns()
        self._stop(t)
        self._start(name, t)

    def synced(self, n: int) -> None:
        """Count ``n`` copies back to the host."""
        if self._acct is not None:
            self._acct.rank_syncs += n

    def _start(self, name: str, t: int) -> None:
        self._name, self._t = name, t
        if self._spans and recording():
            self._rf = torch.profiler.record_function(name)
            self._rf.__enter__()

    def _stop(self, t: int) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        acct = self._acct
        if acct is not None:
            if self._name == GET:
                acct.rank_wait_ns += t - self._t
            else:
                acct.rank_host_ns += t - self._t

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        self._stop(t)
        _local.tiles = self._outer
        if self._outer is not None:
            self._outer._start(self._outer._name, t)
        return False


class Region:
    """A span ``name`` over a stretch of the ranking layer whose host time,
    waits for the device included, adds to the current accounting's
    counter ``field``. It leaves the tiles inside it as they are."""
    __slots__ = ("_name", "_field", "_acct", "_t", "_rf")

    def __init__(self, name: str, field: str):
        self._name = name
        self._field = field

    def __enter__(self) -> "Region":
        self._acct = current()
        self._rf = None
        if recording():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        acct = self._acct
        if acct is not None:
            setattr(acct, self._field,
                    getattr(acct, self._field) + t - self._t)
        return False


def approx() -> Region:
    """Phase 1 of a quantized executor call (``rank.approx``,
    ``approx_ns``)."""
    return Region(APPROX, "approx_ns")


def rescore() -> Region:
    """The exact fp32 rescore (``rank.rescore``, ``rescore_ns``)."""
    return Region(RESCORE, "rescore_ns")
