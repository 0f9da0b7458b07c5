"""Deterministic, seedable fault injection for chaos testing.

"Toward Understanding Bugs in Vector Database Management Systems"
(arXiv 2506.02617) finds the dominant real-world VDBMS bug classes live in
error-handling and recovery paths — code that only runs when an append hits
ENOSPC, a host fetch stalls, or a worker thread dies. Those paths cannot be
exercised by clean-kill tests, so every I/O or thread boundary in this repo
carries a named *seam*: a single ``fire("seam.name")`` call that is a no-op
(one global read + one ``is None`` branch) unless a :class:`FaultInjector`
is installed.

Seam catalog (grep for ``faults.fire`` to audit):

======================== ====================================================
``journal.write``        DSM journal append (``DSMJournal._write``). Site
                         interprets ``short_write``; ``enospc``/``crash``
                         raise here.
``journal.fsync``        fsync after a journal append (only with
                         ``fsync_on_commit=True``).
``journal.compact.tmp``  compaction: tmp file written, ``os.replace`` NOT
                         yet executed (crash-before-replace kill point).
``journal.compact.done`` compaction: after ``os.replace`` (crash-after-
                         replace kill point).
``store.host_fetch``     tiered-store host-row gather in ``gather_rescore``
                         (latency spikes, ``transient`` retryable faults).
``sharded.h2d``          sharded/device staging host-to-device transfer
                         (``ShardedStoreView.sync`` scatter, ``stage_dsq``
                         ``device_put``).
``sched.execute``        scheduler executor thread, per batch before the
                         execute fn (``latency`` = injected kernel slowness,
                         ``error`` = executor exception, ``crash`` = thread
                         death).
``sched.collect``        scheduler collector thread, per formed batch.
``sched.stage``          double-buffer staging step.
``maint.apply``          maintenance op between journal BEGIN and mutation
                         (``crash`` = the classic kill point).
======================== ====================================================

Fault kinds:

* ``latency`` — sleep ``latency_s`` at the seam, then continue normally.
* ``transient`` — raise :class:`TransientFault` (retryable; sites that
  promise bounded retry catch exactly this type).
* ``error`` — raise :class:`FaultError` (non-retryable injected failure).
* ``enospc`` — raise ``OSError(errno.ENOSPC)`` as a real filesystem append
  would.
* ``crash`` — raise :class:`InjectedCrash`, a ``BaseException`` subclass so
  ordinary ``except Exception`` recovery code cannot swallow it: it models
  process death and must unwind to the test/soak harness, which then
  rebuilds state from the journal.
* ``short_write`` — *site-interpreted*: ``fire`` returns the rule and the
  journal writes a prefix of the payload before raising
  :class:`InjectedCrash`, producing a torn tail for reopen-truncation to
  repair.

Any kind may also carry ``latency_s`` (slept before the failure action), so
"stall then fail" schedules need one rule.

Determinism: each rule draws from its own ``random.Random`` seeded from
``(plan.seed, seam, rule index)``, so a rule's trip sequence depends only on
how many times *its* seam was hit — not on interleaving with other seams or
threads. ``after``/``count`` windows give exact (probability-free) placement
for kill-point matrices; ``p`` gives rate-style chaos schedules.

Usage::

    plan = FaultPlan(seed=7).add("store.host_fetch", kind="transient",
                                 p=0.2, count=5)
    with FaultInjector(plan) as inj:
        ...                       # seams are live on every thread
    inj.trips                     # {"store.host_fetch": 3}

Installation is process-global (all threads see the injector — scheduler
worker threads must trip too), guarded against nesting, and always
uninstalled on exit.
"""
from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "FaultError", "TransientFault", "InjectedCrash",
    "FaultRule", "FaultPlan", "FaultInjector",
    "fire", "active",
]


class FaultError(RuntimeError):
    """Non-retryable injected failure at a named seam."""

    def __init__(self, seam: str, detail: str = ""):
        super().__init__(f"injected fault at {seam}" +
                         (f": {detail}" if detail else ""))
        self.seam = seam


class TransientFault(FaultError):
    """Retryable injected failure — sites with bounded-retry contracts
    catch exactly this type."""


class InjectedCrash(BaseException):
    """Simulated process death. Deliberately NOT an ``Exception`` so that
    production recovery/degradation handlers cannot absorb it — only the
    chaos harness (which models the restart) may catch it."""

    def __init__(self, seam: str):
        super().__init__(f"injected crash at {seam}")
        self.seam = seam


_KINDS = ("latency", "transient", "error", "enospc", "crash", "short_write")
# Kinds fire() resolves itself; the rest are returned for the site to enact.
_SELF_SERVE = ("latency", "transient", "error", "enospc", "crash")


@dataclass
class FaultRule:
    """One scheduled fault at one seam.

    ``after`` eligible hits pass untouched, then the next ``count`` hits
    each trip with probability ``p`` (``count=None`` = unbounded trips).
    """
    seam: str
    kind: str = "error"
    p: float = 1.0
    count: Optional[int] = 1
    after: int = 0
    latency_s: float = 0.0
    fraction: float = 0.5          # short_write: payload prefix kept
    _hits: int = field(default=0, repr=False)
    _trips: int = field(default=0, repr=False)
    _rng: Optional[random.Random] = field(default=None, repr=False)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def _should_trip(self) -> bool:
        """Called with the injector lock held."""
        self._hits += 1
        if self._hits <= self.after:
            return False
        if self.count is not None and self._trips >= self.count:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self._trips += 1
        return True


@dataclass
class FaultPlan:
    """A named, seeded schedule of :class:`FaultRule` s."""
    seed: int = 0
    rules: List[FaultRule] = field(default_factory=list)

    def add(self, seam: str, **kw) -> "FaultPlan":
        self.rules.append(FaultRule(seam=seam, **kw))
        return self


_ACTIVE: Optional["FaultInjector"] = None
_INSTALL_LOCK = threading.Lock()


class FaultInjector:
    """Arms a :class:`FaultPlan` process-wide and accounts its trips."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._by_seam: Dict[str, List[FaultRule]] = {}
        self.trips: Dict[str, int] = {}
        for i, rule in enumerate(plan.rules):
            rule._hits = rule._trips = 0
            rule._rng = random.Random(f"{plan.seed}:{rule.seam}:{i}")
            self._by_seam.setdefault(rule.seam, []).append(rule)

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> "FaultInjector":
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a FaultInjector is already installed")
            _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- the hot path -------------------------------------------------------
    def fire(self, seam: str) -> Optional[FaultRule]:
        rules = self._by_seam.get(seam)
        if not rules:
            return None
        tripped = None
        with self._lock:
            for rule in rules:
                if rule._should_trip():
                    tripped = rule
                    self.trips[seam] = self.trips.get(seam, 0) + 1
                    break
        if tripped is None:
            return None
        if tripped.latency_s > 0.0:
            time.sleep(tripped.latency_s)
        kind = tripped.kind
        if kind == "latency":
            return None
        if kind == "transient":
            raise TransientFault(seam)
        if kind == "error":
            raise FaultError(seam)
        if kind == "enospc":
            raise OSError(errno.ENOSPC, "injected: no space left on device",
                          seam)
        if kind == "crash":
            raise InjectedCrash(seam)
        return tripped                      # site-interpreted (short_write)

    def total_trips(self) -> int:
        with self._lock:
            return sum(self.trips.values())


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def fire(seam: str) -> Optional[FaultRule]:
    """Seam entry point. No-op (None) unless an injector is installed.

    May raise :class:`TransientFault`, :class:`FaultError`, ``OSError``
    (ENOSPC) or :class:`InjectedCrash` per the armed plan; returns the rule
    for site-interpreted kinds (``short_write``) after any injected latency.
    """
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.fire(seam)
