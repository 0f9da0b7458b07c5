"""Continuous-batching serving front end: the scheduler, not the caller,
fills the device batch — the port's copy of ``repro/serving/scheduler.py``.

A synchronous ``dsq_batch`` leaves batch shape to whoever happens to call,
and under live traffic the hardware idles between arrivals. This module
turns the per-batch engine into a continuously-batched service (the
sarathi-serve insight applied to scoped vector search):

* **Admission queue + SLO flush.** Concurrent requests enqueue per tenant;
  a collector thread coalesces them into device batches, flushing when the
  batch fills (``max_batch``) OR when the oldest admitted request has waited
  ``max_wait_ms`` — the latency-SLO deadline. Under load the batch is always
  full; at low load no request waits longer than the SLO budget.
* **Weighted-fair admission + backpressure.** Each flush drains tenants in
  proportion to their configured weights (a flooding tenant cannot starve
  the others), every tenant queue is bounded, and an admission past capacity
  raises a typed :class:`AdmissionError` instead of growing the queue — the
  caller sheds or retries, the server never falls behind unboundedly.
* **Double-buffered staging.** While batch N ranks on device, the collector
  stages batch N+1: its unique scopes resolve through the *same*
  epoch-validated :class:`~repro_torch.vectordb.planner.ScopeMaskCache` the
  execution-time plan reads (``BatchPlanner.resolve_scopes``), its packed
  device scope words materialize, and its query matrix is copied through
  pinned host memory to the device on a side stream (:class:`StagedQueries`,
  ordered by a CUDA event before any use). Because
  staging only *warms* token-validated caches, a DSM racing between stage
  and execute simply invalidates the staged entry — the execute-time lookup
  misses and re-resolves, never serving a stale scope.
* **Accounting.** Every executed batch stamps its scheduler timestamps
  (arrival/queue/stage/service) onto the ``BatchAccounting`` attached to its
  results, and :class:`ServingMetrics` aggregates per measurement window:
  p50/p95/p99 latency, QPS, batch occupancy, shed rate —
  ``snapshot(reset=True)`` reads-and-resets a window without re-creating
  the server.

Results are bit-identical to calling ``dsq_batch`` directly with the same
coalesced batch (the scheduler adds no numeric path — it only decides batch
composition), which ``tests/test_torch_serving.py`` enforces across every
ported executor and precision.

Threads and CUDA streams: the collector thread stages while the executing
thread runs the previous batch. Neither enters a ``torch.cuda.stream``
context, so both issue their kernels and the staged scope-word uploads on
the legacy default stream, which orders an upload before every kernel
launched after it from either thread (and a pageable upload has completed
when ``.to`` returns). Only the query copy runs on a side stream, and an
event orders it.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults, trace
from ..core.interface import normalize_batch
from ..vectordb.planner import BatchAccounting, ScopeKey


class AdmissionError(RuntimeError):
    """Typed backpressure: a tenant's admission queue is at capacity. The
    request was NOT enqueued; the caller decides whether to shed or retry
    after draining. Carries the evidence a load-balancer needs."""

    def __init__(self, tenant: str, queued: int, capacity: int):
        super().__init__(
            f"tenant {tenant!r} admission queue full ({queued}/{capacity})")
        self.tenant = tenant
        self.queued = queued
        self.capacity = capacity


class DeadlineExceeded(RuntimeError):
    """Typed per-request deadline miss: the request's budget expired while
    it waited for a batch slot, so it was *shed at formation time* — it
    never occupied device capacity. ``ticket.result()`` raises this; the
    caller distinguishes it from a real failure and may retry with a wider
    budget."""

    def __init__(self, tenant: str, waited_ms: float, deadline_ms: float):
        super().__init__(
            f"tenant {tenant!r} request exceeded its {deadline_ms:.1f}ms "
            f"deadline after waiting {waited_ms:.1f}ms")
        self.tenant = tenant
        self.waited_ms = waited_ms
        self.deadline_ms = deadline_ms


class SchedulerUnhealthy(RuntimeError):
    """Typed fail-fast: the scheduler is in the ``readonly`` health state (a
    worker thread died or ``stop()`` ran) and cannot serve — submits are
    rejected immediately instead of queueing forever against a dead
    executor, and queued tickets are resolved with this error so no caller
    blocks on a batch that will never form."""

    def __init__(self, health: str, detail: str = ""):
        super().__init__(f"scheduler is {health}" +
                         (f": {detail}" if detail else ""))
        self.health = health


class CircuitBreaker:
    """Consecutive-failure circuit breaker for one executor group: after
    ``trip_after`` consecutive batch failures it opens (the scheduler flips
    to ``degraded`` and the owner downshifts the group), and after
    ``reset_after`` consecutive successes in the degraded configuration it
    closes again (upshift + back to ``healthy``). Thread-compatible: only
    ever touched from the executing thread."""

    def __init__(self, trip_after: int = 3, reset_after: int = 4):
        self.trip_after = max(1, trip_after)
        self.reset_after = max(1, reset_after)
        self.failures = 0
        self.successes = 0
        self.open = False
        self.trips = 0

    def record_failure(self) -> bool:
        """Count one batch failure; True when this failure trips the
        breaker open."""
        self.successes = 0
        self.failures += 1
        if not self.open and self.failures >= self.trip_after:
            self.open = True
            self.trips += 1
            return True
        return False

    def record_success(self) -> bool:
        """Count one healthy batch; True when this success closes an open
        breaker."""
        self.failures = 0
        if not self.open:
            return False
        self.successes += 1
        if self.successes >= self.reset_after:
            self.open = False
            self.successes = 0
            return True
        return False


@dataclass
class SchedulerConfig:
    """Flush policy + admission limits for :class:`ContinuousScheduler`.

    ``max_wait_ms`` is the SLO budget a request may spend waiting for its
    batch to fill; the oldest admitted request's deadline triggers the flush.
    ``queue_capacity`` bounds each tenant's admission queue (admissions past
    it raise :class:`AdmissionError`). ``tenant_weights`` sets the per-flush
    fair shares (default weight 1.0).

    ``adaptive=True`` (set by a measured cost model's
    ``scheduler_defaults()``) lets the scheduler refine ``max_wait_ms``
    online from the service times it observes: waiting longer than one
    batch-service interval buys no extra batching, so the effective wait
    tracks an EWMA of the service time, clamped to
    [``min_wait_ms``, the configured ``max_wait_ms`` SLO].

    ``deadline_ms`` is the default per-request completion budget (None =
    no deadline): a request still queued past it is shed with a typed
    :class:`DeadlineExceeded` at batch-formation time instead of occupying
    a slot. ``breaker_trip_after``/``breaker_reset_after`` configure the
    consecutive-failure :class:`CircuitBreaker` that drives the
    ``healthy → degraded`` downshift."""
    max_batch: int = 32
    max_wait_ms: float = 4.0
    queue_capacity: int = 256
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    adaptive: bool = False
    min_wait_ms: float = 0.5
    deadline_ms: Optional[float] = None
    breaker_trip_after: int = 3
    breaker_reset_after: int = 4


class ServingTicket:
    """Await handle for one admitted request: ``result()`` blocks until the
    scheduler's executed batch resolves it (or re-raises the batch failure).
    Timestamps use the scheduler clock: ``t_arrival`` is the admission (or
    caller-supplied scheduled-arrival) time, ``t_done`` the batch completion
    — their difference is the coordinated-omission-safe serving latency."""

    __slots__ = ("tenant", "t_arrival", "t_done", "batch_size", "flush",
                 "t_deadline", "_event", "_result", "_exc", "_cancelled")

    def __init__(self, tenant: str, t_arrival: float,
                 t_deadline: Optional[float] = None):
        self.tenant = tenant
        self.t_arrival = t_arrival
        self.t_deadline = t_deadline     # absolute scheduler-clock budget
        self.t_done: Optional[float] = None
        self.batch_size = 0
        self.flush = ""                  # "size" | "deadline" | "drain"
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """Abandon this request: the scheduler drops it at the next batch
        formation (its queue slot frees, ``_pending`` is released) instead
        of counting it forever — the fix for ``result(timeout)`` timing out
        and leaking the slot. Returns False when the request already
        resolved (it may still be executed if a batch already claimed it);
        cancelling is idempotent."""
        if self._event.is_set():
            return False
        self._cancelled = True
        return True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    @property
    def latency_s(self) -> float:
        assert self.t_done is not None, "request not served yet"
        return self.t_done - self.t_arrival

    def _resolve(self, result, exc: Optional[BaseException] = None) -> None:
        self._result, self._exc = result, exc
        self._event.set()


class _Request:
    __slots__ = ("seq", "tenant", "payload", "t_arrival", "ticket")

    def __init__(self, seq, tenant, payload, t_arrival, ticket):
        self.seq = seq
        self.tenant = tenant
        self.payload = payload
        self.t_arrival = t_arrival
        self.ticket = ticket


class ServingMetrics:
    """Windowed serving accounting: latency percentiles, QPS, batch
    occupancy, shed rate, plus one cumulative :class:`BatchAccounting`
    merged from every executed batch. ``snapshot(reset=True)`` reads the
    current measurement window and starts the next one."""

    def __init__(self, max_batch: int, clock: Callable[[], float] = None):
        self.max_batch = max_batch
        self.clock = clock or time.perf_counter
        self._lock = threading.Lock()
        # health is scheduler *state*, not a window counter: it survives
        # snapshot(reset=True) and only the scheduler's state machine
        # (healthy → degraded → readonly) moves it
        self.health = "healthy"
        self._reset_locked(self.clock())

    def _reset_locked(self, now: float) -> None:
        self.window_start = now
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0                 # deadline-shed (DeadlineExceeded)
        self.cancelled = 0               # caller-abandoned tickets reaped
        self.failed = 0                  # requests resolved with a failure
        self.degrades = 0                # breaker trips this window
        self.recoveries = 0              # breaker closes this window
        self.latencies_s: List[float] = []
        self.queue_waits_s: List[float] = []
        self.batch_sizes: List[int] = []
        self.accounting = BatchAccounting()

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_shed(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += n

    def record_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self.cancelled += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_health(self, health: str, transition: str = "") -> None:
        with self._lock:
            self.health = health
            if transition == "degrade":
                self.degrades += 1
            elif transition == "recover":
                self.recoveries += 1

    def record_batch(self, tickets: Sequence[ServingTicket],
                     queue_waits_s: Sequence[float],
                     acct: Optional[BatchAccounting]) -> None:
        with self._lock:
            self.completed += len(tickets)
            self.latencies_s.extend(t.latency_s for t in tickets)
            self.queue_waits_s.extend(queue_waits_s)
            self.batch_sizes.append(len(tickets))
            if acct is not None:
                self.accounting.merge(acct)

    @staticmethod
    def _pcts(xs: List[float]) -> Dict[str, float]:
        if not xs:
            return {"mean_ms": float("nan"), "p50_ms": float("nan"),
                    "p95_ms": float("nan"), "p99_ms": float("nan")}
        a = np.asarray(xs) * 1e3
        return {"mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "p99_ms": float(np.percentile(a, 99))}

    def snapshot(self, reset: bool = False) -> Dict[str, object]:
        with self._lock:
            now = self.clock()
            window_s = max(now - self.window_start, 1e-9)
            sizes = np.asarray(self.batch_sizes, dtype=np.float64)
            out: Dict[str, object] = {
                "window_s": window_s,
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "expired": self.expired,
                "cancelled": self.cancelled,
                "failed": self.failed,
                "health": self.health,
                "degrades": self.degrades,
                "recoveries": self.recoveries,
                "qps": self.completed / window_s,
                "shed_rate": ((self.rejected + self.expired)
                              / max(self.submitted + self.rejected, 1)),
                "batches": len(self.batch_sizes),
                "mean_batch": float(sizes.mean()) if sizes.size else 0.0,
                "occupancy": (float(sizes.mean()) / self.max_batch
                              if sizes.size else 0.0),
            }
            out.update(self._pcts(self.latencies_s))
            out.update({f"queue_{k}": v for k, v in
                        self._pcts(self.queue_waits_s).items()})
            out["accounting"] = self.accounting.snapshot()
            if reset:
                self._reset_locked(now)
        return out


class ContinuousScheduler:
    """Generic continuous-batching scheduler: admits requests, forms device
    batches under the flush policy, double-buffers staging against
    execution, resolves tickets.

    ``execute(payloads, staged)`` runs one coalesced batch and returns one
    result per payload (arrival order). ``stage(payloads)`` (optional) runs
    on the collector thread — overlapped with the executor thread ranking
    the previous batch — and its return value is handed to ``execute``.
    ``acct_of(results)`` (optional) extracts the batch's
    :class:`BatchAccounting` so scheduler timestamps are stamped onto it
    and merged into :attr:`metrics`.

    Threaded operation: :meth:`start` spawns the collector + executor pair
    (the staged-batch queue between them holds exactly one batch — that is
    the double buffer). Synchronous operation: :meth:`pump` forms, stages
    and executes one batch on the caller thread — the deterministic mode
    the bit-identity tests and benchmarks use."""

    def __init__(self, execute: Callable[[List, object], List],
                 stage: Optional[Callable[[List], object]] = None,
                 cfg: Optional[SchedulerConfig] = None,
                 acct_of: Optional[Callable[[List],
                                            Optional[BatchAccounting]]] = None,
                 clock: Callable[[], float] = None,
                 maintenance: Optional[Callable[[], Optional[dict]]] = None,
                 maintenance_every: int = 8):
        """``maintenance`` is the low-priority background-work hook (e.g.
        ``MaintenanceManager.step``): called on the executor thread, BETWEEN
        device batches — never concurrently with a launch — and idle-first:
        once per idle wait interval when the staging queue runs dry, and
        after every ``maintenance_every``-th executed batch *if no next
        batch is already staged* (a waiting batch wins the slot). Under
        sustained saturation a slot is still forced every
        ``8 * maintenance_every`` batches so maintenance cannot starve.
        One call must do one *bounded* unit of work (or nothing, returning
        None), so serving p99 is bounded by one maintenance step, not a
        full rebuild backlog."""
        self.execute_fn = execute
        self.stage_fn = stage
        self.cfg = cfg or SchedulerConfig()
        self.maintenance_fn = maintenance
        self.maintenance_every = max(1, maintenance_every)
        self.maintenance_force_every = 8 * self.maintenance_every
        # duty-cycle pacing for threaded idle slots: a slice may start only
        # after ~3x the EWMA slice cost has elapsed since the last one, so
        # background repair never monopolizes the process (GIL + cache)
        # while requests trickle in between batches
        self.maintenance_duty_factor = 3.0
        self._maint_cost_ewma_s = 0.0
        self._maint_last_end_s = 0.0
        self._since_maintenance = 0
        self.maintenance_steps = 0
        self.maintenance_error: Optional[BaseException] = None
        # adaptive-wait state: the configured max_wait_ms is the SLO ceiling;
        # the EWMA of observed batch service times refines the effective wait
        self._slo_wait_ms = self.cfg.max_wait_ms
        self._service_ewma_s = 0.0
        self.acct_of = acct_of
        self.clock = clock or time.perf_counter
        self.metrics = ServingMetrics(self.cfg.max_batch, self.clock)
        self._cond = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._rr: List[str] = []         # tenant round-robin order
        self._pending = 0
        self._inflight = 0
        self._seq = 0
        self._running = False
        self._staged: "queue.Queue" = queue.Queue(maxsize=1)
        self._collector: Optional[threading.Thread] = None
        self._executor: Optional[threading.Thread] = None
        self._executing: Optional[List[_Request]] = None
        self._collecting: Optional[List[_Request]] = None
        # Health state machine: healthy → degraded (breaker open, the owner
        # downshifted the executor group) → back to healthy on breaker
        # close; readonly is terminal within a scheduler lifetime (a worker
        # thread died — submits fail fast with SchedulerUnhealthy).
        self.health = "healthy"
        self.breaker = CircuitBreaker(self.cfg.breaker_trip_after,
                                      self.cfg.breaker_reset_after)
        # downshift/upshift hooks, set by the owner (e.g. ScheduledDSQ's
        # degradation ladder); called on the executing thread, never under
        # the admission lock
        self.on_degrade: Optional[Callable[[], None]] = None
        self.on_recover: Optional[Callable[[], None]] = None
        self.last_batch_error: Optional[BaseException] = None
        self.stage_faults = 0            # staging failures absorbed

    # ---------------------------------------------------------------- health
    def _set_health(self, health: str, transition: str = "") -> None:
        self.health = health
        self.metrics.record_health(health, transition)

    def _fail_fast(self, detail: str,
                   executing: Optional[List[_Request]] = None) -> None:
        """A worker thread is dying: flip to ``readonly`` and resolve every
        queued request with a typed :class:`SchedulerUnhealthy` so no caller
        blocks forever on a batch that will never form. ``executing`` is the
        batch the dying executor thread was running (its requests left the
        queues already, so the sweep below cannot see them)."""
        err = SchedulerUnhealthy("readonly", detail)
        with self._cond:
            self._set_health("readonly")
            doomed = []
            for q in self._queues.values():
                doomed.extend(q)
                q.clear()
            self._pending -= len(doomed)
            if executing:
                self._inflight -= len(executing)
            self._cond.notify_all()
        for r in executing or ():
            if not r.ticket.done():
                r.ticket._resolve(None, err)
        for r in doomed:
            r.ticket._resolve(None, err)
        # a staged batch nobody will ever execute (executor death) would
        # strand its tickets AND deadlock stop()'s sentinel put on the
        # 1-slot queue — resolve and drop it
        staged_doomed = 0
        while True:
            try:
                item = self._staged.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            for r in item[0]:
                r.ticket._resolve(None, err)
            staged_doomed += len(item[0])
        if staged_doomed:
            with self._cond:
                self._inflight -= staged_doomed
                self._cond.notify_all()
        self.metrics.record_failed(len(doomed) + staged_doomed
                                   + len(executing or ()))

    # ------------------------------------------------------------- admission
    def submit(self, payload, tenant: str = "default",
               t_arrival: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> ServingTicket:
        """Admit one request; returns its await ticket. Raises
        :class:`AdmissionError` when the tenant's queue is at capacity (the
        request is not enqueued) and :class:`SchedulerUnhealthy` when a
        worker thread has died (fail fast — nothing would ever serve it).
        ``t_arrival`` lets an open-loop driver backdate to the *scheduled*
        arrival time so queueing delay the driver itself introduced still
        counts — the coordinated-omission guard. ``deadline_ms`` (default
        ``cfg.deadline_ms``) is the request's completion budget from
        arrival: still queued past it, it resolves with a typed
        :class:`DeadlineExceeded` instead of occupying a batch slot."""
        now = self.clock()
        if deadline_ms is None:
            deadline_ms = self.cfg.deadline_ms
        with self._cond:
            if self.health == "readonly":
                self.metrics.record_shed()
                raise SchedulerUnhealthy(self.health, "worker thread dead")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rr.append(tenant)
            if len(q) >= self.cfg.queue_capacity:
                self.metrics.record_shed()
                raise AdmissionError(tenant, len(q), self.cfg.queue_capacity)
            arrival = now if t_arrival is None else t_arrival
            ticket = ServingTicket(
                tenant, arrival,
                None if deadline_ms is None
                else arrival + deadline_ms / 1e3)
            q.append(_Request(self._seq, tenant, payload, ticket.t_arrival,
                              ticket))
            self._seq += 1
            self._pending += 1
            self.metrics.record_submit()
            self._cond.notify_all()
        return ticket

    # ---------------------------------------------------------- flush policy
    def _oldest_arrival(self) -> Optional[float]:
        heads = [q[0].t_arrival for q in self._queues.values() if q]
        return min(heads) if heads else None

    def _flush_due(self, now: Optional[float] = None) -> Optional[str]:
        """Why the pending set should flush now: ``"size"`` (max_batch
        reached), ``"deadline"`` (oldest request exhausted its SLO wait
        budget), or None (keep coalescing). Call under the lock."""
        if self._pending == 0:
            return None
        if self._pending >= self.cfg.max_batch:
            return "size"
        oldest = self._oldest_arrival()
        now = self.clock() if now is None else now
        if oldest is not None and (now - oldest) * 1e3 >= self.cfg.max_wait_ms:
            return "deadline"
        return None

    def _reap_locked(self) -> List[Tuple[_Request, float]]:
        """Drop cancelled and deadline-expired requests from the admission
        queues (releasing their ``_pending`` slots) before a batch forms, so
        neither occupies device capacity. Returns the expired requests (with
        their waited seconds) for the caller to resolve with
        :class:`DeadlineExceeded`. Call under the lock."""
        now = self.clock()
        expired: List[Tuple[_Request, float]] = []
        dropped = 0
        for q in self._queues.values():
            if not q:
                continue
            keep = []
            for r in q:
                if r.ticket._cancelled:
                    dropped += 1
                elif (r.ticket.t_deadline is not None
                      and now >= r.ticket.t_deadline):
                    expired.append((r, now - r.t_arrival))
                else:
                    keep.append(r)
            if len(keep) != len(q):
                q.clear()
                q.extend(keep)
        self._pending -= dropped + len(expired)
        if dropped:
            self.metrics.record_cancelled(dropped)
        if expired:
            self.metrics.record_expired(len(expired))
        return expired

    def _resolve_expired(self, expired: List[Tuple[_Request, float]]) -> None:
        for r, waited_s in expired:
            dl = r.ticket.t_deadline
            r.ticket._resolve(None, DeadlineExceeded(
                r.tenant, waited_s * 1e3, (dl - r.t_arrival) * 1e3))

    def _form_batch(self) -> List[_Request]:
        """Drain up to ``max_batch`` requests weighted-fair across tenants:
        each active tenant first gets a slot share proportional to its
        weight (at least one), leftover slots fill in global arrival order.
        The formed batch is sorted by admission sequence, so a single-tenant
        batch is exactly the FIFO prefix — what makes scheduled results
        reproducible against a direct ``dsq_batch`` of the same requests.
        Call under the lock."""
        self._resolve_expired(self._reap_locked())
        active = [t for t in self._rr if self._queues[t]]
        if not active:
            return []
        cap = self.cfg.max_batch
        w = {t: max(float(self.cfg.tenant_weights.get(t, 1.0)), 1e-9)
             for t in active}
        total_w = sum(w.values())
        picked: List[_Request] = []
        for t in active:
            if len(picked) >= cap:
                break
            share = max(1, int(cap * w[t] / total_w))
            q = self._queues[t]
            for _ in range(min(share, len(q), cap - len(picked))):
                picked.append(q.popleft())
        while len(picked) < cap:
            heads = [self._queues[t][0] for t in active if self._queues[t]]
            if not heads:
                break
            nxt = min(heads, key=lambda r: r.seq)
            self._queues[nxt.tenant].popleft()
            picked.append(nxt)
        picked.sort(key=lambda r: r.seq)
        self._pending -= len(picked)
        self._inflight += len(picked)
        self._rr.append(self._rr.pop(0))     # rotate first-share advantage
        return picked

    # ------------------------------------------------------- stage + execute
    def _do_stage(self, batch: List[_Request]) -> Tuple[object, float]:
        if self.stage_fn is None:
            return None, 0.0
        t0 = self.clock()
        with trace.span("sched.stage"):
            try:
                faults.fire("sched.stage")
                staged = self.stage_fn([r.payload for r in batch])
            except Exception:            # noqa: BLE001 — staging only warms
                # token-validated caches: a failed stage costs performance,
                # not correctness. Execute unstaged rather than killing the
                # batch (or, threaded, the collector thread).
                self.stage_faults += 1
                return None, self.clock() - t0
        return staged, self.clock() - t0

    def _run_batch(self, batch: List[_Request], staged, stage_s: float,
                   flush: str) -> None:
        t0 = self.clock()
        try:
            # Seam: "latency" = injected kernel slowness, "error" = executor
            # exception (fans out to the batch's tickets, counts toward the
            # breaker), "crash" = thread death (InjectedCrash is a
            # BaseException, so it escapes this handler by design).
            faults.fire("sched.execute")
            with trace.span("sched.exec"):
                results = self.execute_fn([r.payload for r in batch],
                                          staged)
            if len(results) != len(batch):
                raise RuntimeError(f"execute returned {len(results)} results "
                                   f"for {len(batch)} requests")
        except Exception as e:     # KeyboardInterrupt/SystemExit propagate
            self.last_batch_error = e
            for r in batch:
                r.ticket._resolve(None, e)
            self.metrics.record_failed(len(batch))
            with self._cond:
                self._inflight -= len(batch)
                self._cond.notify_all()
            if self.breaker.record_failure() and self.health == "healthy":
                # trip: downshift the executor group, serve degraded
                self._set_health("degraded", "degrade")
                if self.on_degrade is not None:
                    self.on_degrade()
            return
        t1 = self.clock()
        if self.breaker.record_success() and self.health == "degraded":
            # sustained success in the degraded configuration: upshift
            self._set_health("healthy", "recover")
            if self.on_recover is not None:
                self.on_recover()
        if self.cfg.adaptive:
            ewma = self._service_ewma_s
            self._service_ewma_s = (0.2 * (t1 - t0) + 0.8 * ewma
                                    if ewma else t1 - t0)
            self.cfg.max_wait_ms = min(
                self._slo_wait_ms,
                max(self.cfg.min_wait_ms, self._service_ewma_s * 1e3))
        with trace.span("sched.done"):
            acct = (self.acct_of(results) if self.acct_of is not None
                    else None)
            if acct is not None:
                # serving-pipeline timestamps onto the results' own
                # accounting: the caller sees where its batch sat (queue vs
                # stage vs service)
                acct.sched_batches += 1
                acct.sched_arrival_ns = int(
                    min(r.t_arrival for r in batch) * 1e9)
                acct.sched_queue_ns += int(
                    sum(t0 - r.t_arrival for r in batch) * 1e9)
                acct.sched_stage_ns += int(stage_s * 1e9)
                acct.sched_service_ns += int((t1 - t0) * 1e9)
                acct.sched_occupancy += len(batch) / self.cfg.max_batch
            tickets = []
            for r, res in zip(batch, results):
                r.ticket.batch_size = len(batch)
                r.ticket.flush = flush
                r.ticket.t_done = t1
                tickets.append(r.ticket)
            self.metrics.record_batch(
                tickets, [t0 - r.t_arrival for r in batch], acct)
            for r, res in zip(batch, results):
                r.ticket._resolve(res)
            with self._cond:
                self._inflight -= len(batch)
                self._cond.notify_all()

    def pump(self) -> int:
        """Synchronously form + stage + execute ONE batch of whatever is
        pending (no flush-policy wait). Returns the number of requests
        served. The deterministic single-thread mode: tests and the
        bit-identity gates submit a known request set, pump once, and
        compare against the direct ``dsq_batch`` of the same batch."""
        with self._cond, trace.span("sched.form"):
            batch = self._form_batch()
        if not batch:
            self._maybe_maintain(force=True)
            return 0
        staged, stage_s = self._do_stage(batch)
        self._run_batch(batch, staged, stage_s, "pump")
        self._since_maintenance += 1
        self._maybe_maintain()
        return len(batch)

    def _maybe_maintain(self, force: bool = False,
                        busy: bool = False) -> None:
        """One bounded maintenance step on the executing thread (between
        batches — maintenance never overlaps a device launch). ``busy``
        means a staged batch is already waiting: yield the slot to it
        unless maintenance has been starved past the forced interval. A
        step that raises records the error and disables the hook rather
        than killing the serving loop."""
        if self.maintenance_fn is None:
            return
        if not force:
            if self._since_maintenance < self.maintenance_every:
                return
            if busy and self._since_maintenance < self.maintenance_force_every:
                return
        self._since_maintenance = 0
        t0 = self.clock()
        try:
            with trace.span("sched.maint"):
                ran = self.maintenance_fn()
            if ran is not None:
                self.maintenance_steps += 1
                dt = self.clock() - t0
                self._maint_cost_ewma_s = (dt if not self._maint_cost_ewma_s
                                           else 0.7 * self._maint_cost_ewma_s
                                           + 0.3 * dt)
        except Exception as e:              # keep serving; a crash-kind
            # injected fault (InjectedCrash is a BaseException) or a real
            # KeyboardInterrupt/SystemExit must propagate instead
            self.maintenance_error = e
            self.maintenance_fn = None
        finally:
            self._maint_last_end_s = self.clock()

    # ------------------------------------------------------------ thread pair
    def _collect_loop(self) -> None:
        # The loop body catches nothing below Exception on purpose: an
        # escaping exception IS thread death — flip to readonly so submits
        # fail fast and queued callers
        # get a typed error instead of the scheduler silently going dark.
        # KeyboardInterrupt/SystemExit still propagate after the flip.
        try:
            self._collect_body()
        except faults.InjectedCrash:
            self._fail_fast("collector thread died (injected crash)",
                            executing=self._collecting)
        except BaseException:
            self._fail_fast("collector thread died",
                            executing=self._collecting)
            raise

    def _collect_body(self) -> None:
        while True:
            with self._cond:
                while (self._running and self._pending == 0
                       and self.health != "readonly"):
                    self._cond.wait()
                if self.health == "readonly":
                    break                # executor died: nothing to feed
                if not self._running and self._pending == 0:
                    break
                flush = None
                while self._running:
                    flush = self._flush_due()
                    if flush is not None:
                        break
                    oldest = self._oldest_arrival()
                    if oldest is None:
                        break
                    budget = (self.cfg.max_wait_ms / 1e3
                              - (self.clock() - oldest))
                    self._cond.wait(timeout=max(budget, 1e-4))
                if self._pending == 0:
                    continue
                with trace.span("sched.form"):
                    batch = self._form_batch()   # stop(): drain what remains
                flush = flush or "drain"
            if batch:
                self._collecting = batch  # for fail-fast resolution on death
                faults.fire("sched.collect")
                staged, stage_s = self._do_stage(batch)
                # blocks while one batch is already staged and one executes:
                # exactly one batch of lookahead — the double buffer. The
                # put is health-aware: an executor that died mid-wait would
                # otherwise leave us blocked on a queue nobody drains.
                while True:
                    try:
                        self._staged.put((batch, staged, stage_s, flush),
                                         timeout=0.05)
                        self._collecting = None
                        break
                    except queue.Full:
                        if self.health == "readonly":
                            err = SchedulerUnhealthy(
                                "readonly", "executor thread dead")
                            for r in batch:
                                r.ticket._resolve(None, err)
                            self.metrics.record_failed(len(batch))
                            with self._cond:
                                self._inflight -= len(batch)
                                self._cond.notify_all()
                            return

    def _execute_loop(self) -> None:
        try:
            self._execute_body()
        except faults.InjectedCrash:
            self._fail_fast("executor thread died (injected crash)",
                            executing=self._executing)
        except BaseException:
            self._fail_fast("executor thread died",
                            executing=self._executing)
            raise

    def _execute_body(self) -> None:
        while True:
            if self.maintenance_fn is not None:
                try:
                    item = self._staged.get(
                        timeout=max(self.cfg.max_wait_ms, 1.0) / 1e3)
                except queue.Empty:
                    # idle slot: no batch staged — maintenance runs for
                    # free, paced to a bounded duty cycle (see __init__)
                    gap = self.clock() - self._maint_last_end_s
                    if gap >= (self.maintenance_duty_factor
                               * self._maint_cost_ewma_s):
                        self._maybe_maintain(force=True)
                    continue
            else:
                item = self._staged.get()
            if item is None:
                break
            self._executing = item[0]    # for fail-fast resolution on death
            self._run_batch(*item)
            self._executing = None
            self._since_maintenance += 1
            self._maybe_maintain(busy=not self._staged.empty())

    def start(self) -> "ContinuousScheduler":
        if self._running:
            return self
        self._running = True
        self._collector = threading.Thread(target=self._collect_loop,
                                           name="cb-collector", daemon=True)
        self._executor = threading.Thread(target=self._execute_loop,
                                          name="cb-executor", daemon=True)
        self._collector.start()
        self._executor.start()
        return self

    def stop(self) -> None:
        """Drain: the collector keeps flushing until the admission queues are
        empty, then the executor finishes the staged tail."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._collector is not None:
            self._collector.join()
            self._collector = None
        if self.health == "readonly":
            # a worker died: resolve anything stranded between the
            # fail-fast sweep and the collector's exit so the sentinel
            # put below cannot block on a full queue nobody drains
            self._fail_fast("stopped while readonly")
        self._staged.put(None)
        if self._executor is not None:
            self._executor.join()
            self._executor = None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has been served."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._pending == 0 and self._inflight == 0, timeout)

    def __enter__(self) -> "ContinuousScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class StagedQueries:
    """A coalesced batch's query matrix on its way to the device: a pinned
    host copy (``host``), the device tensor a ``non_blocking`` copy fills on
    the owner's side stream (``device``), and the CUDA event recorded on that
    stream after the copy (``event``). Nothing may read ``device`` before
    the event: :meth:`wait` orders a consumer's stream after it. The object
    holds the pinned buffer until :meth:`release` has seen the event
    complete (PyTorch's pinned allocator also keeps a block whose recorded
    copy is pending)."""

    __slots__ = ("host", "device", "event")

    def __init__(self, queries: np.ndarray, device: torch.device,
                 stream: "torch.cuda.Stream"):
        self.host = torch.from_numpy(queries).pin_memory()
        with torch.cuda.stream(stream):
            self.device = self.host.to(device, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def wait(self, stream: Optional["torch.cuda.Stream"] = None
             ) -> torch.Tensor:
        """Order ``stream`` (the caller's current stream by default) after
        the copy and return the device matrix; the allocator learns the
        tensor is used there, so its block is not reused under the read."""
        stream = stream or torch.cuda.current_stream(self.device.device)
        stream.wait_event(self.event)
        self.device.record_stream(stream)
        return self.device

    def release(self) -> None:
        """Block until the copy has completed; after this the pinned buffer
        may be freed."""
        self.event.synchronize()


def stage_dsq(db, payloads: List[Tuple], k: int, namespace: str,
              executor: str,
              stream: Optional["torch.cuda.Stream"] = None) -> object:
    """Staging pass for a coalesced DSQ batch (runs on the collector thread
    while the previous batch ranks): resolve the batch's unique scopes
    through the planner's epoch-validated mask cache, materialize the packed
    device form the executor's scan will read (words for flat/ivf/sharded,
    the dense bool mask for pg), pre-pin sharded scan scopes into the
    executor's resident scope table (token-validated: the execute-time
    ``ensure_scope`` then hits without re-uploading), and start the query
    matrix's host->device transfer.
    Everything staged here is validated by scope-epoch tokens at execute
    time, so a DSM landing between stage and execute invalidates rather than
    corrupts.

    On a CUDA database the query matrix is copied into pinned memory and on
    to the device with ``non_blocking=True`` on ``stream`` (the owner's side
    stream; a fresh one from PyTorch's pool when None), returned as a
    :class:`StagedQueries`; on the CPU the matrix is returned as it is. The
    scope words upload on this thread's current stream — the legacy default
    stream, which the executing thread's kernels also run on (module
    docstring)."""
    from ..vectordb.sharded import ShardedExecutor

    queries, paths, rec, exc = assemble_dsq(payloads)
    idx = db.namespaces[namespace]
    planner = db.planner(namespace)
    n = len(db.store)
    keys = [ScopeKey.from_spec(s) for s in normalize_batch(paths, rec, exc)]
    resolved, _ = planner.resolve_scopes(idx, n, keys)
    ex = db.executors.get(executor)
    scan_entries = []
    for key, ent in resolved.items():
        if planner.choose_plan(ent.scope_size, n, k) != "scan":
            continue
        if executor == "pg":
            ent.bool_mask                    # PG traversal reads dense bool
        else:
            ent.words                        # packed words: flat/ivf/sharded
        scan_entries.append((key, ent))
    if isinstance(ex, ShardedExecutor) and scan_entries:
        # pre-pin the scan scopes into the shards' scope table (token-
        # validated, so the execute-time ensure_scope hits), never between
        # the executing batch's pins and its launch
        with ex.pinned():
            ex.sync()
            ex.reserve(len(scan_entries))
            for key, ent in scan_entries:
                ex.ensure_scope(namespace, key, ent)
    if db.device.type != "cuda":
        return queries
    if stream is None:
        stream = torch.cuda.Stream(device=db.device)
    return StagedQueries(queries, db.device, stream)


def assemble_dsq(payloads: List[Tuple]
                 ) -> Tuple[np.ndarray, List[str], List[bool],
                            Optional[List[List[str]]]]:
    """(query matrix, paths, recursive flags, exclude lists) of a coalesced
    DSQ batch, in admission order."""
    queries = np.stack([p[0] for p in payloads]).astype(np.float32)
    paths = [p[1] for p in payloads]
    rec = [p[2] for p in payloads]
    exc = ([list(p[3]) for p in payloads]
           if any(p[3] for p in payloads) else None)
    return queries, paths, rec, exc


class ScheduledDSQ:
    """Async submit/await front end over :meth:`DirectoryVectorDB.dsq_batch`:
    one scheduler per serving configuration (k / executor / precision are
    batch-shape decisions, so they are scheduler-level — per-request scope,
    recursive flag and exclusions ride the payload). Scheduled results are
    bit-identical to a direct ``dsq_batch`` of the same coalesced batch."""

    def __init__(self, db, k: int = 10, namespace: str = "fs",
                 executor: str = "flat", precision: str = "fp32",
                 rescore_k: Optional[int] = None,
                 cfg: Optional[SchedulerConfig] = None,
                 stage: bool = True, maintenance: object = None,
                 maintenance_every: int = 8, degrade: bool = True,
                 **executor_params):
        """``maintenance=True`` attaches the db's
        :class:`~repro_torch.vectordb.maintenance.MaintenanceManager` for
        ``namespace`` as the scheduler's between-batches hook; passing a
        manager (or any ``step``-bearing object / zero-arg callable) uses
        that instead.

        ``degrade=True`` arms the degradation ladder: when the scheduler's
        circuit breaker trips (consecutive batch failures), the serving
        configuration downshifts — ``sharded`` falls back to ``flat``
        (bit-identical results, no mesh staging on the faulting H2D path),
        ``fp32`` falls back to the two-phase ``int8`` plan, and the
        approximate executors' search budgets shrink (IVF ``nprobe``
        halves, PG ``ef_search`` halves) — every step recall-clamped
        through the cost model's floors (``pick_rescore_k``'s rescore
        factor, ``default_nprobe``, ``ef >= 2k``), so a degraded answer is
        a narrower search, never an unclamped one. When the breaker closes
        the original configuration is restored. ``executor_params`` are
        forwarded to ``dsq_batch`` (e.g. ``nprobe=…``, ``ef_search=…``)."""
        self.db = db
        self.k = k
        self.namespace = namespace
        self.executor = executor
        self.precision = precision
        self.rescore_k = rescore_k
        self.executor_params = dict(executor_params)
        # the side stream staged query copies run on (made at the first
        # stage of a CUDA database)
        self._stream: Optional["torch.cuda.Stream"] = None
        # original (healthy) configuration, restored on breaker close
        self._healthy_cfg = (executor, precision, rescore_k,
                             dict(executor_params))
        self._cfg_lock = threading.Lock()
        self.degrade_enabled = degrade
        self.degrade_level = 0
        if cfg is None:
            # a measured cost model sizes the batch at the knee of its
            # calibrated service-time curve (and turns on adaptive wait);
            # heuristic/roofline models keep the stock SchedulerConfig
            from ..vectordb.costmodel import model_of
            defaults = model_of(db.store).scheduler_defaults()
            if defaults is not None:
                cfg = SchedulerConfig(**defaults)
        if maintenance is True:
            maintenance = db.maintenance(namespace)
        if maintenance is not None and hasattr(maintenance, "step"):
            maintenance = maintenance.step
        self.scheduler = ContinuousScheduler(
            self._execute,
            stage=self._stage if stage else None,
            cfg=cfg,
            acct_of=lambda results: results[0].batch if results else None,
            maintenance=maintenance,
            maintenance_every=maintenance_every)
        if degrade:
            self.scheduler.on_degrade = self._downshift
            self.scheduler.on_recover = self._upshift

    # ------------------------------------------------------ degradation ladder
    def _downshift(self) -> None:
        """Breaker tripped: move one rung down the ladder (executing
        thread). Each rung is recall-clamped — see ``__init__``."""
        from ..vectordb.costmodel import model_of
        with self._cfg_lock:
            model = model_of(self.db.store)
            if self.executor == "sharded" and "flat" in self.db.executors:
                self.executor = "flat"
            if self.precision == "fp32":
                # two-phase int8: ~4x fewer scan bytes; the rescore window
                # stays at the model's recall-gated floor (pick_rescore_k
                # never narrows below DEFAULT_RESCORE_FACTOR * k)
                self.precision = "int8"
                self.rescore_k = model.pick_rescore_k(
                    self.k, self.rescore_k, len(self.db.store))
            if self.executor == "ivf":
                ex = self.db.executors.get("ivf")
                n_lists = getattr(ex, "n_lists", 0)
                if n_lists:
                    floor = model.default_nprobe(n_lists)
                    cur = self.executor_params.get("nprobe", floor)
                    self.executor_params["nprobe"] = max(floor, cur // 2)
            if self.executor == "pg":
                cur = self.executor_params.get("ef_search", 64)
                self.executor_params["ef_search"] = max(2 * self.k, cur // 2)
            self.degrade_level += 1

    def _upshift(self) -> None:
        """Breaker closed after sustained degraded success: restore the
        healthy configuration."""
        with self._cfg_lock:
            (self.executor, self.precision, self.rescore_k,
             params) = self._healthy_cfg
            self.executor_params = dict(params)
            self.degrade_level = 0

    # scheduler surface, re-exported for callers
    @property
    def metrics(self) -> ServingMetrics:
        return self.scheduler.metrics

    @property
    def health(self) -> str:
        return self.scheduler.health

    def start(self) -> "ScheduledDSQ":
        self.scheduler.start()
        return self

    def stop(self) -> None:
        self.scheduler.stop()

    def pump(self) -> int:
        """Synchronous single-batch step (see ContinuousScheduler.pump)."""
        return self.scheduler.pump()

    def __enter__(self) -> "ScheduledDSQ":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def submit(self, query: np.ndarray, path: str, recursive: bool = True,
               exclude: Sequence[str] = (), tenant: str = "default",
               t_arrival: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> ServingTicket:
        payload = (np.asarray(query, np.float32), path, bool(recursive),
                   tuple(exclude or ()))
        return self.scheduler.submit(payload, tenant=tenant,
                                     t_arrival=t_arrival,
                                     deadline_ms=deadline_ms)

    def _stage(self, payloads: List[Tuple]) -> object:
        with self._cfg_lock:
            executor = self.executor
        if self._stream is None and self.db.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.db.device)
        return stage_dsq(self.db, payloads, self.k, self.namespace,
                         executor, stream=self._stream)

    def _execute(self, payloads: List[Tuple], staged) -> List:
        queries, paths, rec, exc = assemble_dsq(payloads)
        with self._cfg_lock:
            # snapshot the (possibly downshifted) serving configuration so
            # one batch executes one coherent rung of the ladder
            executor, precision = self.executor, self.precision
            rescore_k, params = self.rescore_k, dict(self.executor_params)
        try:
            return self.db.dsq_batch(queries, paths, k=self.k, recursive=rec,
                                     exclude=exc, namespace=self.namespace,
                                     executor=executor, precision=precision,
                                     rescore_k=rescore_k, **params)
        finally:
            # dsq_batch ranks the host matrix, so nothing reads the staged
            # device copy: its pinned buffer goes once the copy is done
            if isinstance(staged, StagedQueries):
                staged.release()


def open_loop_arrivals(qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Seeded Poisson arrival process: ``n`` scheduled arrival offsets (s)
    at target rate ``qps``. Open-loop drivers (``chip_smoke.py`` phase 7)
    submit at these *scheduled* times and measure latency
    from them — the coordinated-omission-safe protocol: a slow service
    cannot delay the arrivals that would have exposed it."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(qps, 1e-9), size=n)
    return np.cumsum(gaps)
