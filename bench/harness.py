"""One run of one cell: set-up, the measured window, the reading of the
metrics and the check of every sampled answer against the reference.

Everything is found by name: the cell in ``BENCHMARK.json`` and in
``bench/workloads/<cell>.json``, its configuration in
``bench/configs/<config>.json``, each traffic stream's generator in
``bench/traffic/<kind>.py`` and each metric's reader in
``bench/metrics/<metric>.py`` (or, for a split name such as
``ann_ms.sat``, ``bench/metrics/ann_ms.py``). The program is driven only
through its public entry points: ``DirectoryVectorDB`` (``ingest``,
``dsq_batch``, ``dsm_batch``) behind ``ScheduledDSQ``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import datagen, reference, roofline

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0
WARM_S = 2.0
CHECK_SAMPLE = 1024
CHECK_DIRS = 256


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py``, or for a metric whose file is absent,
    ``bench/metrics/<name up to its first dot>.py``."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists() and kind == "metrics":
        path = BENCH / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's ``BENCHMARK.json`` entry, workload file, configuration
    and the metrics it reports (end-to-end and per-layer)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    work = load_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "chips"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: {key} {work[key]!r} in the workload "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    cfg = load_json(BENCH / "configs" / f"{entry['config']}.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {"entry": entry, "workload": work, "config": cfg,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def with_workload(name: str) -> dict:
    """``BENCHMARK.json``, with the cell ``name`` added from its workload
    file when it is not listed yet (the sweep and the controls of a cell
    that a later change proves)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if all(w["name"] != name for w in bench["workloads"]):
        work = load_json(BENCH / "workloads" / f"{name}.json")
        bench["workloads"].append({k: work[k] for k in
                                   ("config", "traffic", "chips", "why")}
                                  | {"name": name})
    return bench


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------ records
class DSQReq:
    """A request in flight: held only until its answer has been read."""
    __slots__ = ("idx", "ticket")

    def __init__(self, idx, ticket):
        self.idx = idx
        self.ticket = ticket

    def done(self) -> bool:
        return self.ticket is None or self.ticket.done()

    def wait(self, timeout: float) -> None:
        if self.ticket is not None:
            try:
                self.ticket.result(timeout)
            except Exception:       # noqa: BLE001 - recorded when read
                pass


PENDING, OK, FAILED, SHED = 0, 1, 2, 3
KEEP_ONE_IN = 8     # answers kept for the check: about one request in 8


@dataclass
class DSMOp:
    kind: str
    src: str
    dst: str
    arrival: float
    seq: int
    ack: Optional[float] = None
    error: Optional[str] = None


@dataclass
class BatchRec:
    t_start: float
    t_end: float
    state: int
    size: int
    anchors: List[str] = field(default_factory=list)
    recursive: List[bool] = field(default_factory=list)
    acct: object = None


class Run:
    """One run of one cell. ``device`` is ``"cuda"`` for the benchmark;
    the tests pass ``"cpu"`` and ``overrides`` (``scale``, ``dim``,
    ``query_pool``, ``check_sample``, ``warm_s``) to drive the same path
    small."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None,
                 overrides: Optional[dict] = None, out=None):
        import torch
        self.torch = torch
        self.spec = spec
        self.cfg = dict(spec["config"])
        self.overrides = overrides or {}
        for key in ("dim", "query_pool", "check_sample"):
            if key in self.overrides:
                self.cfg[key] = self.overrides[key]
        self.work = spec["workload"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.clock = time.perf_counter
        self.t_start = self.clock() if t_start is None else t_start
        self.out = out or sys.stdout
        self.k = int(self.cfg["k"])
        self.window_k = 4 * self.k if self.cfg["precision"] == "int8" else \
            self.k
        self.parts: Dict[str, float] = {}
        # one entry per DSQ request, in submission order; numbers only, so
        # the records add nothing for the collector to walk
        self.arrival: List[float] = []
        self.done_t: List[float] = []
        self.status: List[int] = []
        self.pool_of: List[int] = []
        self.kept: Dict[int, tuple] = {}
        self._out = deque()
        self._keep = np.random.default_rng([self.seed, 8])
        self._acct_state: Dict[int, int] = {}
        self.ops: List[DSMOp] = []
        self.batches: List[BatchRec] = []
        self.hook_calls: List[tuple] = []    # (t_start, t_end, n_ops)
        self.applied = 0                     # ops acknowledged so far
        self._dsm_lock = threading.Lock()
        self._dsm_pending: List[DSMOp] = []
        self._pool_next = 0
        self._submit_lock = threading.Lock()

    # ---------------------------------------------------------------- emit
    def emit(self, obj: dict) -> None:
        print(json.dumps(obj), file=self.out, flush=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    # --------------------------------------------------------------- set-up
    def generate(self) -> None:
        """The run's data, query pool and DSM templates, from the seed."""
        torch = self.torch
        cfg = self.cfg
        data = datagen.make_structure(cfg, self.overrides.get("scale", 1.0))
        data.dim = int(cfg["dim"])
        datagen.make_vectors(torch, data, self.seed, self.device)
        self.data = data
        self.pool = datagen.make_queries(torch, data, int(cfg["query_pool"]),
                                         self.seed, self.device)
        self.order = np.random.default_rng([self.seed, 3]).permutation(
            len(self.pool.anchors))
        self.streams_cfg = self.work["streams"]
        self.replay = None
        if any(s["kind"] == "dsm_stream" for s in self.streams_cfg):
            self.templates = datagen.dsm_templates(
                data.tree, int(cfg["dsm_templates"]), self.seed)
            self._template_next = 0
            self.replay = self._base_state()
        self._sync()

    def setup(self) -> None:
        torch = self.torch
        from repro_torch.serving.scheduler import (SchedulerConfig,
                                                   ScheduledDSQ)
        from repro_torch.vectordb import DirectoryVectorDB

        cfg = self.cfg
        t = self.clock()
        self.generate()
        data = self.data
        self.parts["generate_s"] = self.clock() - t

        t = self.clock()
        # every configuration journals its DSM acknowledgements
        jdir = (Path(os.environ.get("TMPDIR") or "/tmp")
                / f"bench-journal-{os.getpid()}")
        jdir.mkdir(parents=True, exist_ok=True)
        self.journal_dir = jdir
        db = DirectoryVectorDB(dim=data.dim, metric=cfg["metric"],
                               scope_strategy=cfg["scope_strategy"],
                               journal_path=str(jdir / "dsm"),
                               calibration=False, device=self.device)
        # every directory of the dataset exists, entries or not (as the
        # paper's benchmarks build it), then the entries go in bulk
        trees = {"fs": data.tree, **{n: t for n, (t, _) in data.extra.items()}}
        for name, tree in trees.items():
            idx = db.namespace(name)
            for p in tree.paths:
                idx.mkdir(p)
        extra = {name: data.entry_paths(name) for name in data.extra}
        db.ingest(data.vectors, data.entry_paths(), namespaces=extra or None)
        db.build_ann(cfg["executor"])
        db.store.device_vectors()
        self._sync()
        self.parts["ingest_upload_s"] = self.clock() - t

        t = self.clock()
        if cfg["precision"] == "int8":
            db.store.device_q_vectors()
            db.store.device_q_scales()
        self._sync()
        self.parts["index_quantise_s"] = self.clock() - t
        self.db = db

        t = self.clock()
        sc = cfg["scheduler"]
        hook = self._maintenance if self.replay is not None else None
        self.sdsq = ScheduledDSQ(
            db, k=self.k, namespace="fs", executor=cfg["executor"],
            precision=cfg["precision"], rescore_k=cfg.get("rescore_k"),
            cfg=SchedulerConfig(max_batch=int(sc["max_batch"]),
                                max_wait_ms=float(sc["max_wait_ms"]),
                                queue_capacity=int(sc["queue_capacity"])),
            stage=True, maintenance=hook, maintenance_every=1,
            degrade=False)
        sched = self.sdsq.scheduler
        self._execute = sched.execute_fn
        sched.execute_fn = self._execute_recorded
        if self.trace:
            self._instrument()
            from . import devtrace
            devtrace.warm(torch, self.device)
        # one full batch straight through the facade: builds or loads the
        # kernels and warms the allocator at the cell's batch shape
        B = int(sc["max_batch"])
        idx = self.order[:B]
        db.dsq_batch(self.pool.vectors[idx],
                     [self.pool.anchors[i] for i in idx], k=self.k,
                     recursive=[bool(r) for r in self.pool.recursive[idx]],
                     executor=cfg["executor"], precision=cfg["precision"],
                     rescore_k=cfg.get("rescore_k"))
        self._sync()
        self.parts["warmup_batch_s"] = self.clock() - t
        # ingest leaves millions of objects (the directory, the store's
        # host arrays) that live as long as the process: collect once now,
        # then freeze them, so that no full collection walks them again and
        # stops every thread for 1.4-2.0 s inside the window
        t = self.clock()
        gc.collect()
        gc.freeze()
        self.parts["collect_s"] = self.clock() - t
        self.emit({"setup": self.parts})

    def _base_state(self) -> reference.DirState:
        tree = self.data.tree
        counts = np.bincount(self.data.assign, minlength=len(tree))
        return reference.DirState(tree.paths, counts)

    # ------------------------------------------------------ program hooks
    def _execute_recorded(self, payloads, staged):
        rec = BatchRec(self.clock(), 0.0, self.applied, len(payloads))
        if self.trace:
            rec.anchors = [p[1] for p in payloads]
            rec.recursive = [bool(p[2]) for p in payloads]
            with self.torch.profiler.record_function(
                    f"bench.batch#{len(self.batches)}"):
                results = self._execute(payloads, staged)
        else:
            results = self._execute(payloads, staged)
        rec.t_end = self.clock()
        rec.acct = results[0].batch if results else None
        self._acct_state[id(rec.acct)] = rec.state
        self.batches.append(rec)
        return results

    def _instrument(self) -> None:
        """``record_function`` spans around the calls into each layer (the
        traced run only): planning, ranking, staging, DSM."""
        rf = self.torch.profiler.record_function

        def span(name, fn):
            def wrapped(*a, **kw):
                with rf(name):
                    return fn(*a, **kw)
            return wrapped
        planner = self.db.planner("fs")
        planner.plan = span("dsq.directory", planner.plan)
        ex = self.db.executors[self.cfg["executor"]]
        ex.search = span("dsq.rank", ex.search)
        ex.search_multi = span("dsq.rank", ex.search_multi)
        sched = self.sdsq.scheduler
        sched.stage_fn = span("dsq.stage", sched.stage_fn)

    def _maintenance(self):
        """The scheduler's between-batches hook: apply every DSM op that
        has arrived, in arrival order, as one ``dsm_batch``."""
        with self._dsm_lock:
            ops, self._dsm_pending = self._dsm_pending, []
        if not ops:
            return None
        t0 = self.clock()
        if self.trace:
            with self.torch.profiler.record_function("dsm.apply"):
                res = self.db.dsm_batch([(o.kind, o.src, o.dst) for o in ops])
        else:
            res = self.db.dsm_batch([(o.kind, o.src, o.dst) for o in ops])
        t1 = self.clock()
        for o, err in zip(ops, res.errors):
            o.ack = t1
            o.error = None if err is None else repr(err)
        self.applied += len(ops)
        self.hook_calls.append((t0, t1, len(ops)))
        return {"ops": len(ops)}

    # ------------------------------------------------------------- traffic
    def submit_dsq(self, arrival: float) -> DSQReq:
        from repro_torch.serving.scheduler import AdmissionError
        with self._submit_lock:
            self._reap()
            idx = len(self.arrival)
            i = int(self.order[idx % len(self.order)])
            self.arrival.append(arrival)
            self.done_t.append(float("nan"))
            self.status.append(PENDING)
            self.pool_of.append(i)
        pool = self.pool
        try:
            ticket = self.sdsq.submit(pool.vectors[i], pool.anchors[i],
                                      recursive=bool(pool.recursive[i]),
                                      t_arrival=arrival)
        except AdmissionError:
            self.status[idx] = SHED
            return DSQReq(idx, None)
        req = DSQReq(idx, ticket)
        with self._submit_lock:
            self._out.append(req)
        return req

    def _reap(self) -> None:
        """Read every answered request at the head of the line (answers
        come back in admission order) and let go of it."""
        out = self._out
        while out and out[0].done():
            r = out.popleft()
            t = r.ticket
            try:
                res = t.result(0)
            except Exception:       # noqa: BLE001 - a failed batch
                self.status[r.idx] = FAILED
                continue
            self.status[r.idx] = OK
            self.done_t[r.idx] = t.t_done
            if self._keep.random() * KEEP_ONE_IN < 1.0:
                self.kept[r.idx] = (self.pool_of[r.idx],
                                    self._acct_state[id(res.batch)],
                                    np.array(res.ids[0], np.int64),
                                    np.array(res.scores[0], np.float32))

    def submit_dsm(self, arrival: float) -> bool:
        """Hand the next applicable template to the hook; False when the
        templates run out."""
        while self._template_next < len(self.templates):
            kind, src, dst = self.templates[self._template_next]
            self._template_next += 1
            if not self.replay.valid(kind, src, dst):
                continue
            self.replay.apply(kind, src, dst)
            op = DSMOp(kind, src, dst, arrival, len(self.ops))
            self.ops.append(op)
            with self._dsm_lock:
                self._dsm_pending.append(op)
            return True
        return False

    # -------------------------------------------------------------- window
    def window(self) -> None:
        torch = self.torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        streams = [load_module("traffic", s["kind"]).Stream(self, s,
                                                            self.seed)
                   for s in self.streams_cfg]
        self.streams = streams
        self.gc_pauses = []
        gc.callbacks.append(self._gc_event)
        self.sdsq.start()
        t_warm = self.clock()
        self.t0 = t_warm + float(self.overrides.get("warm_s", WARM_S))
        self.t1 = self.t0 + self.seconds
        for s in streams:
            s.start(self.t1)
        self._sleep_until(self.t0)
        self.setup_s = self.t0 - self.t_start
        cache = self.db.planner("fs").cache
        stats0 = dict(cache.stats())
        if self.trace:
            from . import devtrace
            self.profile = devtrace.Window(torch, self)
            self._sleep_until(self.t0 + 0.1 * self.seconds)
            # the profiler takes a while to start: the stretch is timed
            # from when it has
            self.traced = [self.clock()]
            self.profile.start()
            self.profile.started_s = self.clock() - self.traced[0]
            self._sleep_until(min(self.clock() + 5.0,
                                  self.t1 - 0.1 * self.seconds))
            self.profile.stop()
            self.traced.append(self.clock())
        self._sleep_until(self.t1)
        stats1 = dict(cache.stats())
        self.cache_delta = {k: stats1[k] - stats0[k] for k in stats0}
        for s in streams:
            s.join(DRAIN_S)
        deadline = self.clock() + DRAIN_S
        for r in list(self._out):
            r.wait(max(0.0, deadline - self.clock()))
        with self._submit_lock:
            self._reap()
        while self.clock() < deadline:
            with self._dsm_lock:
                left = bool(self._dsm_pending)
            if not left:
                break
            time.sleep(0.01)
        self.t_drained = self.clock()
        gc.callbacks.remove(self._gc_event)
        self.sdsq.stop()
        self._sync()
        self.memory_peak = (int(torch.cuda.max_memory_allocated())
                            if self.device.type == "cuda" else 0)
        self.lateness = [x for s in streams for x in getattr(s, "late_s", ())]

    def _gc_event(self, phase: str, info: dict) -> None:
        """Full collections stop every thread of the process: record each
        one's start and length (gc.callbacks; nothing is changed)."""
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._gc_t = self.clock()
        elif getattr(self, "_gc_t", None) is not None:
            self.gc_pauses.append((self._gc_t, self.clock() - self._gc_t))
            self._gc_t = None

    def _sleep_until(self, t: float) -> None:
        while True:
            left = t - self.clock()
            if left <= 0:
                return
            time.sleep(min(left, 0.05))

    # ------------------------------------------------------------- results
    def in_window(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def _window_dsq(self) -> np.ndarray:
        arr = np.asarray(self.arrival)
        return np.flatnonzero((arr >= self.t0) & (arr < self.t1))

    def dsq_latencies(self) -> np.ndarray:
        """Seconds from each window request's scheduled arrival to its
        answer, in arrival order; a request that failed or was shed counts
        as waiting until the drain ended."""
        w = self._window_dsq()
        arr = np.asarray(self.arrival)[w]
        done = np.asarray(self.done_t)[w]
        ok = np.asarray(self.status)[w] == OK
        return np.where(ok, done, self.t_drained) - arr

    def ok_latencies(self) -> np.ndarray:
        """The latencies of the window's answered requests only."""
        w = self._window_dsq()
        ok = np.asarray(self.status)[w] == OK
        return (np.asarray(self.done_t)[w] - np.asarray(self.arrival)[w])[ok]

    def dsq_completed_in_window(self) -> int:
        done = np.asarray(self.done_t)
        ok = np.asarray(self.status) == OK
        return int(np.count_nonzero(ok & (done >= self.t0)
                                    & (done <= self.t1)))

    def dsm_latencies(self) -> np.ndarray:
        return np.asarray([(o.ack if o.ack is not None else self.t_drained)
                           - o.arrival for o in self.ops
                           if self.in_window(o.arrival)])

    def window_batches(self) -> List[BatchRec]:
        """Batches run inside the window; in a traced run, those outside
        the profiled stretch (the profiler slows the host)."""
        a, b = getattr(self, "traced", (self.t1, self.t1))
        return [x for x in self.batches
                if self.t0 <= x.t_start and x.t_end <= self.t1
                and (x.t_end < a or x.t_start > b)]

    def window_hook_calls(self) -> List[tuple]:
        return [c for c in self.hook_calls
                if self.t0 <= c[0] and c[1] <= self.t1]

    def counts(self) -> Dict[str, int]:
        st = np.asarray(self.status, np.int64)[self._window_dsq()]
        attempted = len(st)
        failed = int(np.count_nonzero(st != OK))
        never = int(np.count_nonzero(st == PENDING))
        for o in self.ops:
            if not self.in_window(o.arrival):
                continue
            attempted += 1
            if o.ack is None or o.error is not None:
                failed += 1
            never += int(o.ack is None)
        return {"attempted": attempted, "failed": failed, "never": never}

    def read_metrics(self, entries: List[dict]) -> Dict[str, dict]:
        out = {}
        for m in entries:
            value = load_module("metrics", m["name"]).read(self, m)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    # -------------------------------------------------------- trace reading
    def batch_bounds(self) -> Dict[int, float]:
        """Roofline bound (s) of every traced batch, from the reference's
        scope sets at the state the batch saw."""
        trace = getattr(self, "trace_info", None)
        if trace is None:
            return {}
        peaks = roofline.PEAKS
        base = self._base_state() if self.replay is not None else None
        wanted = sorted({self.batches[i].state for i in trace.batch_ids})
        states = (reference.states_of([(o.kind, o.src, o.dst)
                                       for o in self.ops], base, wanted)
                  if base is not None else {0: self._base_state()})
        out = {}
        prec = self.cfg["precision"]
        for i in trace.batch_ids:
            b = self.batches[i]
            st = states[b.state]
            spans = [st.span(a, r) for a, r in zip(b.anchors, b.recursive)]
            sizes = [st.rows_in([s]) for s in spans]
            scanned = [s for s, m in zip(spans, sizes)
                       if prec == "fp32" or m > self.window_k]
            work = roofline.batch_work(prec, int(self.cfg["dim"]), self.k,
                                       self.window_k, sizes,
                                       st.rows_in(scanned))
            out[i] = roofline.bound_s(work, peaks)
        return out

    def device_name(self) -> str:
        return (self.torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")

    # ------------------------------------------------------------ the check
    def snapshot_answers(self) -> None:
        """Pick the sample (drawn from the seed) and keep what the program
        answered, and read back the DSM targets' scopes, before the
        program's state is freed."""
        kept = [j for j in sorted(self.kept)
                if self.in_window(self.arrival[j])]
        rng = np.random.default_rng([self.seed, 6])
        n = min(int(self.cfg.get("check_sample", CHECK_SAMPLE)), len(kept))
        pick = sorted(rng.choice(len(kept), n, replace=False).tolist())
        self.sample = [self.kept[kept[j]] for j in pick]
        self.dsm_readback = {}
        if self.ops:
            final = self.replay
            paths = sorted({(o.dst + reference._name(o.src)
                             if o.kind == "move" else o.dst)
                            for o in self.ops})
            paths = [p for p in paths if final.exists(p)][:CHECK_DIRS]
            idx = self.db.namespaces["fs"]
            for p in paths:
                self.dsm_readback[p] = np.asarray(
                    idx.resolve(p, recursive=True).to_array(), np.int64)

    def free_program(self) -> None:
        gc.unfreeze()
        for name in ("sdsq", "db"):
            if hasattr(self, name):
                delattr(self, name)
        if hasattr(self, "journal_dir"):
            shutil.rmtree(self.journal_dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def scope_masks(self, sample: list) -> tuple:
        """(the states after each op count the sample needs, the sample's
        directory masks (B, n_dirs) and query rows), by the reference."""
        data = self.data
        states = reference.states_of(
            [(o.kind, o.src, o.dst) for o in self.ops], self._base_state(),
            [s for _, s, _, _ in sample] + [len(self.ops)])
        masks = np.zeros((len(sample), len(data.tree)), bool)
        for j, (i, s, _, _) in enumerate(sample):
            st = states[s]
            dirs = st.dirs_in([st.span(self.pool.anchors[i],
                                       bool(self.pool.recursive[i]))])
            masks[j, dirs] = True
        queries = (self.pool.vectors[[i for i, _, _, _ in sample]]
                   if sample else np.zeros((0, data.dim), np.float32))
        return states, masks, queries

    def ranker(self, plan: str, window: int) -> reference.Ranker:
        return reference.Ranker(self.torch, self.data.vectors,
                                self.data.assign, self.device, plan, window)

    def check(self, answers: Optional[list] = None,
              ranker: Optional[reference.Ranker] = None) -> Dict[str, dict]:
        """The numbers compared, each with its limit. ``answers`` puts
        another ranking in the program's place (the controls); by default
        the program's sampled answers are judged."""
        cfg = self.cfg
        limits = cfg["check"]
        data = self.data
        sample = self.sample if answers is None else answers
        states, masks, queries = self.scope_masks(sample)
        ranker = ranker or self.ranker(cfg["precision"], self.window_k)
        ref_ids, _ = ranker.topk(queries, masks, self.k)
        got_ids = np.stack([a for _, _, a, _ in sample]) if sample else \
            np.zeros((0, self.k), np.int64)
        got_scores = np.stack([b for _, _, _, b in sample]) if sample else \
            np.zeros((0, self.k), np.float32)
        ref_exact = ranker.scores_of(queries, ref_ids)
        got_exact = ranker.scores_of(queries, got_ids)
        bad = 0
        score_err = 0.0
        rank_gap = 0.0
        for j in range(len(sample)):
            ids = got_ids[j]
            valid = ids[ids >= 0]
            want = int((ref_ids[j] >= 0).sum())
            in_scope = masks[j, data.assign[valid]] if len(valid) else \
                np.zeros(0, bool)
            if (len(valid) != want or len(set(valid.tolist())) != len(valid)
                    or not in_scope.all() or (ids[:len(valid)] < 0).any()):
                bad += 1
                continue
            if want == 0:
                continue
            score_err = max(score_err, float(np.max(np.abs(
                got_scores[j][:want] - got_exact[j][:want]))))
            r = np.sort(ref_exact[j][:want])[::-1]
            g = np.sort(got_exact[j][:want])[::-1]
            rank_gap = max(rank_gap, float(np.max(r - g)))
        counts = self.counts()
        out = {"bad_answers": {"value": bad, "limit": 0},
               "score_err": {"value": score_err,
                             "limit": limits["score_err"]},
               "rank_gap": {"value": rank_gap, "limit": limits["rank_gap"]},
               "never_answered": {"value": counts["never"], "limit": 0},
               "sampled": {"value": len(sample), "limit": 1}}
        if self.ops:
            final = states[len(self.ops)]
            mismatch = 0
            for p, got in self.dsm_readback.items():
                want = reference.scope_rows(
                    data.assign, final.dirs_in([final.span(p, True)]))
                mismatch += int(not np.array_equal(np.sort(got), want))
            out["dsm_rejected"] = {"value": sum(o.error is not None
                                                for o in self.ops),
                                   "limit": 0}
            out["dsm_scope_mismatch"] = {"value": mismatch, "limit": 0}
        return out


def passed(checks: Dict[str, dict]) -> bool:
    ok = True
    for name, c in checks.items():
        if name == "sampled":
            ok &= c["value"] >= c["limit"]
        else:
            ok &= c["value"] <= c["limit"]
    return bool(ok)


def execute(spec: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            overrides: Optional[dict] = None, faults=None, out=None,
            err=None) -> dict:
    """Set up, measure, check; return the result line's object."""
    err = err or sys.stderr
    run = Run(spec, seed, seconds, trace, device, t_start, overrides, out)
    run.setup()
    if faults is not None:
        faults(run)
    run.window()
    metrics_of = spec["per_layer"] if trace else spec["end_to_end"]
    if trace:
        run.trace_info = run.profile.read()
        run.emit({"trace": run.trace_info.summary()})
    metrics = run.read_metrics(metrics_of)
    run.emit({"window": {"t0_s": run.t0 - run.t_start,
                         "seconds": run.seconds, "batches": len(run.batches),
                         "dsq": len(run.arrival), "dsm": len(run.ops),
                         "late_p99_ms": (float(np.percentile(
                             run.lateness, 99)) * 1e3
                             if run.lateness else 0.0),
                         "cache": run.cache_delta,
                         "gc_full": [[a - run.t0, d] for a, d in run.gc_pauses
                                     if run.in_window(a)]}})
    counts = run.counts()
    run.snapshot_answers()
    run.free_program()
    checks = run.check()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err,
              flush=True)
    line = {"correct": passed(checks), "attempted": counts["attempted"],
            "failed": counts["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if run.device.type == "cuda"
                       else "cpu",
                       "kind": run.device_name(), "count": 1,
                       "memory_peak_bytes": run.memory_peak}}
    if trace:
        line["device"]["busy_s"] = run.trace_info.busy_s
        line["device"]["window_s"] = run.trace_info.window_s
        line["breakdown"] = run.trace_info.breakdown()
    line["checks"] = checks
    return line
