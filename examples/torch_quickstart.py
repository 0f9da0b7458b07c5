"""Quickstart of the PyTorch port: directory-semantic vector search.

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds the paper's running example (Fig. 2), runs recursive / non-recursive /
exclusion DSQs, then restructures the namespace with MOVE + MERGE and shows
that retrieval follows the new topology — under all three strategies.
"""
import argparse

import numpy as np

from repro_torch.vectordb import DirectoryVectorDB

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without a card) or cpu")
DEVICE = ap.parse_args().device

rng = np.random.default_rng(0)
DIM = 32

DOCS = {
    1: "/HR/",             2: "/HR/Policies/",
    3: "/Dept_A/",         5: "/Dept_A/",
    8: "/Dept_A/OKR/",     9: "/Dept_B/OKR/",
    7: "/Archive/HR/",
}

for strategy in ("pe_online", "pe_offline", "triehi"):
    print(f"\n=== strategy: {strategy} ===")
    db = DirectoryVectorDB(dim=DIM, scope_strategy=strategy, device=DEVICE)
    vecs = rng.normal(size=(len(DOCS), DIM)).astype(np.float32)
    ids = db.ingest(vecs, list(DOCS.values()))
    id_of = dict(zip(DOCS.keys(), ids))
    db.build_ann("flat")

    q = vecs[0] + 0.1 * rng.normal(size=DIM).astype(np.float32)

    r = db.dsq(q, "/HR/", k=5, recursive=True)
    print(f"recursive /HR/        -> scope={r.scope_size} "
          f"(directory-only {r.directory_ns/1e3:.0f}us, "
          f"ann {r.ann_ns/1e3:.0f}us)")

    r = db.dsq(q, "/HR/", k=5, recursive=False)
    print(f"non-recursive /HR/    -> scope={r.scope_size}")

    r = db.dsq(q, "/", k=5, exclude=["/Archive/"])
    print(f"/ minus /Archive/     -> scope={r.scope_size}")

    # DSM: move Dept_A under Dept_B, then merge the OKR conflict
    db.move("/Dept_A/", "/Dept_B/")
    r = db.dsq(q, "/Dept_B/", k=5)
    print(f"after MOVE            -> /Dept_B/ scope={r.scope_size}")
    db.move("/Dept_B/Dept_A/", "/")          # put it back
    db.merge("/Dept_A/", "/Dept_B/")
    r = db.dsq(q, "/Dept_B/OKR/", k=5)
    print(f"after MERGE           -> /Dept_B/OKR/ scope={r.scope_size} "
          f"(doc_8 + doc_9 reconciled)")
    db.check_invariants()
    print("invariants OK; stats:", db.stats()["namespaces"])

# --- dsq_batch: N concurrent requests, one engine pass ---------------------
# Serving traffic repeats scopes. dsq_batch resolves each unique scope once,
# caches its packed mask (invalidated by scope epochs on DSM), and shares one
# ranking launch across all broad-scope requests — bit-identical results to
# the loop above, a fraction of the work.
print("\n=== dsq_batch: batched multi-scope DSQ ===")
db = DirectoryVectorDB(dim=DIM, scope_strategy="triehi", device=DEVICE)
vecs = rng.normal(size=(len(DOCS), DIM)).astype(np.float32)
db.ingest(vecs, list(DOCS.values()))
db.build_ann("flat")
queries = np.stack([vecs[i % len(DOCS)] for i in range(8)])
scopes = ["/HR/", "/HR/", "/Dept_A/", "/", "/", "/HR/", "/Dept_B/", "/"]
results = db.dsq_batch(queries, scopes, k=3)
acct = results[0].batch
print(f"batch of {acct.batch_size} requests -> "
      f"{acct.unique_scopes} scope resolutions, {acct.launches} launches "
      f"(plans: {acct.plan_groups})")
for scope, r in zip(scopes[:3], results[:3]):
    print(f"  {scope:10s} plan={r.plan:6s} scope={r.scope_size} "
          f"shared_by={r.scope_shared} top={r.ids[0][:3].tolist()}")
# a DSM op bumps the scope epochs: the next batch re-resolves, never stale
db.merge("/Dept_A/", "/Dept_B/")
again = db.dsq_batch(queries, scopes, k=3)
print(f"after MERGE: /Dept_A/ scope={again[2].scope_size} (was "
      f"{results[2].scope_size}); cache {db.planner().cache.stats()}")

# --- batched IVF / PG: the approximate executors ride the same engine ------
# IVF partitions live in a device-resident padded-CSR layout; the whole batch
# probes, gathers and ranks in ONE fused launch with each request's packed
# scope mask ANDed in-register (pass nprobe a list for per-request budgets —
# one launch per distinct value). PG shares each unique scope's traversal
# mask across its requests. Deleted entries are tombstoned at the store and
# masked out of both executors, even unscoped.
print("\n=== dsq_batch: batched IVF / PG executors ===")
db.build_ann("ivf", n_lists=4)
db.build_ann("pg", max_degree=4, ef_construction=16)
for executor, params in (("ivf", {"nprobe": 2}), ("pg", {"ef_search": 16})):
    results = db.dsq_batch(queries, scopes, k=3, executor=executor, **params)
    acct = results[0].batch
    print(f"{executor}: batch of {acct.batch_size} -> "
          f"{acct.unique_scopes} scope resolutions, "
          f"{acct.launches} launches; top={results[0].ids[0].tolist()}")

# --- DSM at scale: dsm_batch, rmdir, crash recovery ------------------------
# Maintenance is journaled (BEGIN durable before the mutation, COMMIT after)
# and region-locked. dsm_batch group-commits a whole op sequence: one journal
# append for all BEGINs, FIFO region scheduling (disjoint subtrees apply
# concurrently, overlapping ones in submission order), one shared COMMIT.
# DSMStats counts the write amplification each strategy pays (Table II).
# Under TrieHI, DSM emits delta events so the dsq_batch mask cache *patches*
# cached scopes on the affected ancestor chains instead of evicting them.
# rmdir removes a subtree recursively: postings/nodes dropped, catalog
# unbound, store rows tombstoned so no executor surfaces them again.
print("\n=== DSM: batched maintenance, rmdir, journal recovery ===")
import os
import tempfile

from repro_torch.core import DSM, DSMStats

with tempfile.TemporaryDirectory() as tmp:
    jp = os.path.join(tmp, "dsm.journal")
    db = DirectoryVectorDB(dim=DIM, scope_strategy="triehi", journal_path=jp,
                           device=DEVICE)
    vecs = rng.normal(size=(len(DOCS), DIM)).astype(np.float32)
    db.ingest(vecs, list(DOCS.values()))
    db.build_ann("flat")
    db.dsq_batch(queries, scopes, k=3)              # warm the mask cache

    stats = DSMStats()
    batch = db.dsm_batch([("mkdir", "/Staging/"),
                          ("move", "/Archive/", "/Staging/"),
                          ("merge", "/Dept_A/", "/Dept_B/")], stats=stats)
    print(f"dsm_batch: {batch.applied}/3 applied, "
          f"write_touches={stats.write_touches}, "
          f"cache {db.planner().cache.stats()}")     # patched, not evicted

    removed = db.rmdir("/Staging/")                  # recursive removal
    print(f"rmdir /Staging/ -> {len(removed)} entries tombstoned; "
          f"scope={db.dsq(q, '/', k=5).scope_size}")

    # crash simulation: BEGIN hits the journal, the process dies before
    # COMMIT. On restart the reopened journal continues its seq numbers,
    # and recover() rolls the suspect forward idempotently.
    db._dsm["fs"].journal.begin(DSM("move", "/HR/Policies/", "/Dept_B/"))
    db2 = DirectoryVectorDB(dim=DIM, scope_strategy="triehi", journal_path=jp,
                           device=DEVICE)
    db2.ingest(vecs, list(DOCS.values()))            # restore index state
    for op in (("mkdir", "/Staging/"), ("move", "/Archive/", "/Staging/"),
               ("merge", "/Dept_A/", "/Dept_B/")):
        db2.dsm_batch([op])                          # re-applied history
    db2.rmdir("/Staging/")
    replayed = db2.recover()                         # replays the lost move
    db2.check_invariants()                           # raises on violation
    print(f"recovered: replayed {[op.src for op in replayed['fs']]}; "
          f"invariants OK")

# --- sharded serving tier: the mesh as a first-class executor ---------------
# The store rows shard over a ShardMesh (one shard per visible card by
# default; build_ann("sharded", n_shards=4) puts four on one card) and a DSQ
# batch is one scan launch per shard: local masked top-k per shard, an
# O(shards*k) merge, scope masks served from a device-resident packed-word
# table (token-validated; DSM deltas patch the resident words in place with
# a word-range scatter instead of re-resolving + re-uploading). Results are
# bit-identical to executor="flat" at any shard count.
print("\n=== sharded serving tier: dsq_batch(executor='sharded') ===")
db = DirectoryVectorDB(dim=DIM, scope_strategy="triehi", device=DEVICE)
vecs = rng.normal(size=(len(DOCS), DIM)).astype(np.float32)
db.ingest(vecs, list(DOCS.values()))
# broaden /HR/ past the gather threshold so its packed words live in the
# device-resident scope table (selective scopes ride the gather plan and
# never occupy a slot)
db.ingest(rng.normal(size=(200, DIM)).astype(np.float32),
          ["/HR/Policies/"] * 200)
db.build_ann("flat")
db.build_ann("sharded")
results = db.dsq_batch(queries, scopes, k=3, executor="sharded")
flat = db.dsq_batch(queries, scopes, k=3, executor="flat")
acct = results[0].batch
assert all(np.array_equal(a.ids, b.ids) for a, b in zip(results, flat))
print(f"sharded == flat (bit-identical) over {acct.batch_size} requests; "
      f"{acct.n_shards} shard(s), {acct.launches} launches "
      f"(plans: {acct.plan_groups}), mask upload {acct.shard_mask_bytes}B, "
      f"collective {acct.collective_bytes}B")
db.dsm_batch([("mkdir", "/Staging/"), ("move", "/HR/Policies/", "/Staging/")])
results = db.dsq_batch(queries, scopes, k=3, executor="sharded")
ex = db.executors["sharded"]
print(f"after DSM: shard-resident masks patched in place "
      f"({ex.stats()['masks_patched']} patched, "
      f"{ex.stats()['mask_bytes_patched']}B scattered, "
      f"0 re-uploads) — results still bit-identical to flat:",
      all(np.array_equal(a.ids, b.ids) for a, b in zip(
          results, db.dsq_batch(queries, scopes, k=3, executor="flat"))))

# --- int8 quantized tier: precision as a planned dimension ------------------
# precision="int8" ranks against the int8 scalar-quantized device store
# (symmetric per-row scale: ~0.27x the fp32 bytes, so one device holds ~3.8x
# more corpus and a bandwidth-bound scan reads ~4x fewer bytes). Execution
# is two-phase: the quantized
# scan/gather selects rescore_k (default 4*k) candidates, then an EXACT fp32
# gather-rescore ranks the final top-k — returned scores are always true
# fp32 scores, and the only approximation is which candidates survive
# phase 1 (recall@10 >= 0.99 at the default window; raise rescore_k to trade
# latency for recall, rescore_k=n degenerates to the exact result). The
# BatchPlanner picks the precision per scope group: broad scan-plan scopes
# quantize, selective gather scopes the rescore window covers stay on the
# exact fp32 gather (int8 would win nothing there). Works on every executor:
# flat/sharded scans, IVF's gathered tiles, PG's traversal all read int8.
print("\n=== int8 quantized tier: dsq_batch(precision='int8') ===")
exact = db.dsq_batch(queries, scopes, k=3)
quant = db.dsq_batch(queries, scopes, k=3, precision="int8")
acct = quant[0].batch


def recall(a_batch, b_batch):
    want = [set(int(x) for x in a.ids[0] if x >= 0) for a in a_batch]
    got = [set(int(x) for x in b.ids[0] if x >= 0) for b in b_batch]
    return sum(len(w & g) for w, g in zip(want, got)) / sum(
        len(w) for w in want)


print(f"int8 store {acct.db_bytes_int8}B vs fp32 {acct.db_bytes_fp32}B "
      f"({acct.db_bytes_int8 / max(acct.db_bytes_fp32, 1):.2f}x), "
      f"groups {acct.precision_groups}, "
      f"{acct.rescore_candidates} candidates fp32-rescored, "
      f"recall@3 vs exact = {recall(exact, quant):.2f} "
      f"(rescore_k=n would be exact by construction; at benchmark scale "
      f"the default 4k window already holds recall@10 >= 0.99)")

# --- PQ/ADC tier + tiered fp32 storage: past the device byte budget ---------
# precision="pq" ranks against product-quantized codes: M uint8 codes per row
# (256 k-means centroids per subspace, codebook trained once on first use and
# frozen — new rows encode incrementally, tombstones mask out like any other
# precision). That is ~1/16 of the fp32 bytes by default, and scoring is a
# per-query LUT gather-accumulate (no GEMM), so the scan wall-clock win holds
# on every backend. Same two-phase
# contract as int8: exact fp32 gather-rescore ranks the final top-k.
print("\n=== PQ/ADC tier: dsq_batch(precision='pq') ===")
pq = db.dsq_batch(queries, scopes, k=3, precision="pq")
acct = pq[0].batch
print(f"pq codes {acct.db_bytes_pq}B vs fp32 {acct.db_bytes_fp32}B "
      f"({acct.db_bytes_pq / max(acct.db_bytes_fp32, 1):.3f}x), "
      f"groups {acct.precision_groups}, "
      f"recall@3 vs exact = {recall(exact, pq):.2f}")

# Tiered storage: grow the corpus past a device byte budget and it STILL
# serves — codes (plus the 256*dim*4-byte codebook) stay device-resident,
# fp32 rows demote to host RAM, default-precision requests auto-upgrade to
# the PQ scan, and only the rescore window's rows are fetched host->device.
# The planner's cumulative scope heat pins the hottest directories' fp32
# rows back on device, so a skewed workload converges toward device-speed
# serving.
print("\n=== tiered storage: corpus larger than the device budget ===")
db.ingest(rng.normal(size=(2000, DIM)).astype(np.float32),
          ["/HR/Reports/"] * 2000)               # outgrow the device
exact = db.dsq_batch(queries, scopes, k=3)       # fully resident baseline
db.store.set_device_budget(db.store.alive_nbytes() // 2)
# fp32 requests, pq scan under the hood; rescore_k widens the exact-rescore
# window (the codebook froze before the 2000-row ingest, so the coarser
# codes on the new rows want a bigger window)
cold = db.dsq_batch(queries, scopes, k=3, rescore_k=64)
warm = db.dsq_batch(queries, scopes, k=3, rescore_k=64)   # hot scopes pinned
a_cold, a_warm = cold[0].batch, warm[0].batch
print(f"budget {db.store.device_budget}B for "
      f"{db.store.alive_nbytes()}B of fp32 rows: "
      f"groups {a_cold.precision_groups} (auto-upgraded), "
      f"rescore fetch {a_cold.rescore_fetch_bytes}B cold -> "
      f"{a_warm.rescore_fetch_bytes}B warm, "
      f"{a_warm.rows_device_pinned} rows pinned / {a_warm.rows_host} on host, "
      f"recall@3 vs exact = {recall(exact, warm):.2f}")
db.store.set_device_budget(None)                 # back to fully device-resident

# --- continuous-batching serving: the scheduler fills the batch --------------
# Everything above hands dsq_batch a caller-assembled batch. Under live
# traffic requests arrive one at a time, so a serving front end must form
# the batch itself: submit() admits each request into a bounded per-tenant
# queue (AdmissionError past capacity — typed backpressure, never unbounded
# growth), and the scheduler flushes a device batch when max_batch fills OR
# the oldest request's SLO wait budget (max_wait_ms) expires. Staging for
# batch N+1 (scope-mask resolution + query upload) overlaps batch N's
# ranking, and every staged mask is scope-epoch validated, so a DSM racing
# the pipeline invalidates instead of serving stale scopes. Results are
# bit-identical to a direct dsq_batch of the same coalesced batch.
print("\n=== continuous batching: ScheduledDSQ ===")
from repro_torch.serving import AdmissionError, ScheduledDSQ, SchedulerConfig

sdsq = ScheduledDSQ(db, k=3, cfg=SchedulerConfig(
    max_batch=8, max_wait_ms=10.0, queue_capacity=64,
    tenant_weights={"interactive": 3.0, "batch": 1.0}))
with sdsq:                                       # starts collector+executor
    tickets = [sdsq.submit(queries[i], scopes[i],
                           tenant=("interactive", "batch")[i % 2])
               for i in range(8)]
    results = [t.result(timeout=30.0) for t in tickets]
direct = db.dsq_batch(queries, scopes, k=3)
print(f"scheduled == direct (bit-identical): "
      f"{all(np.array_equal(r.ids[0], d.ids[0]) for r, d in zip(results, direct))}")
snap = sdsq.metrics.snapshot()
print(f"served {snap['completed']} in {snap['batches']} batch(es), "
      f"occupancy {snap['occupancy']:.2f}, p99 {snap['p99_ms']:.1f} ms, "
      f"shed rate {snap['shed_rate']:.2f}")
t = tickets[0]
print(f"ticket: batch_size={t.batch_size}, flush={t.flush!r}, "
      f"latency {t.latency_s * 1e3:.1f} ms "
      f"(measured from scheduled arrival — coordinated-omission-safe)")

# --- calibrated cost model: measure the constants instead of trusting them --
# Every decision above (gather-vs-scan crossover, rescore window, precision,
# kernel tiling, scheduler batch shape) defaults to hand-set heuristics. A
# one-off microbenchmark sweep calibrates them for THIS backend:
#
#     PYTHONPATH=src python -m repro_torch.analysis.calibrate --smoke \
#         --device cuda --out build/cuda.json
#
# and the artifact plugs straight into the database. The committed
# calibration/cpu.json was swept on a CPU backend, where the headline
# measured decision is that int8 scans lose to fp32, so the model upgrades
# int8 requests to exact fp32. An artifact of another backend than the
# database's device degrades to the roofline model (on a card: this one).
print("\n=== calibrated cost model ===")
import os

from repro_torch.vectordb.costmodel import model_of

art = os.path.join(os.path.dirname(__file__), "..", "calibration",
                   "cpu.json")
cal_db = DirectoryVectorDB(dim=DIM, calibration=art,    # or a dict, or False
                           device=DEVICE)
cal_db.ingest(rng.normal(size=(512, DIM)).astype(np.float32),
              ["/docs/"] * 512)
cal_db.build_ann("flat")
model = model_of(cal_db.store)
print(f"model: {model} threshold={model.gather_threshold():.3f} "
      f"(heuristic hand-set: 0.05)")
cal_q = rng.normal(size=(4, DIM)).astype(np.float32)
cal_db.dsq_batch(cal_q, ["/docs/"] * 4, k=3, precision="int8")  # warm-up
res = cal_db.dsq_batch(cal_q, ["/docs/"] * 4, k=3, precision="int8")
a = res[0].batch
print(f"int8 request under the measured model -> groups "
      f"{a.precision_groups} (upgraded when fp32 measures faster), "
      f"plan_source={a.plan_source}, predicted ann "
      f"{a.predicted_ann_ns / 1e3:.0f}us vs actual {a.ann_ns / 1e3:.0f}us")
# REPRO_CALIBRATION=calibration/cpu.json applies the artifact process-wide
# (every DirectoryVectorDB() without an explicit calibration= picks it up);
# calibration=False pins the hand-set heuristics bit-for-bit.

# --- online maintenance: serve through streaming churn ----------------------
# Under live delete + drifted re-ingest traffic the built indexes rot:
# tombstones pile up in the store, IVF partitions skew off their frozen
# centroids, PG rows fill with dead neighbors. A MaintenanceManager runs the
# counter-moves (PG repair / compaction with full id-remap / IVF
# repartition) as journaled, crash-recoverable ops — either inline between
# ingest waves, or from the scheduler's idle-first maintenance slots
# (ScheduledDSQ(maintenance=True)) so serving p99 stays bounded.
print("\n=== online maintenance ===")
from repro_torch.vectordb import MaintenancePolicy

m_db = DirectoryVectorDB(dim=DIM, device=DEVICE)
m_db.mkdir("/docs/")
m_db.ingest(rng.normal(size=(512, DIM)).astype(np.float32), ["/docs/"] * 512)
m_db.build_ann("flat")
m_db.build_ann("ivf", n_lists=8)
m_db.build_ann("pg")
mgr = m_db.maintenance(policy=MaintenancePolicy(tombstone_min=32,
                                                tombstone_fraction=0.05,
                                                repair_deletes=32))
for wave in range(4):                      # churn: delete + drifted re-ingest
    for i in range(wave * 64, wave * 64 + 64):
        m_db.delete(i)
    m_db.ingest(rng.normal(size=(64, DIM)).astype(np.float32),
                ["/docs/"] * 64)
    mgr.run_all()                          # bounded slices between waves
while mgr.run_all():                       # quiesce: drain the deferred
    pass                                   # repair queue, then compact
print(f"after churn: rows={len(m_db.store)} dead={m_db.store.n_deleted} "
      f"ops={mgr.stats()['ops_run']}")     # bounded rows, zero tombstones
# a crash mid-op replays from the journal: db.recover() re-runs any
# uncommitted maintenance intent deterministically (gen-counter idempotent)

# --- fault injection + graceful degradation: serve through failures ---------
# Every I/O and thread boundary in the stack calls faults.fire("<seam>") —
# free when no injector is installed, a deterministic seeded fault schedule
# under chaos. Three layers answer the faults: (1) bounded retry — transient
# host-fetch faults re-attempt with exponential backoff inside the store,
# results bit-identical to the fault-free run; (2) a consecutive-failure
# circuit breaker in the serving front end — repeated executor faults
# downshift one rung (sharded->flat, fp32->int8 with a recall-clamped
# rescore window, nprobe/ef_search halved toward their floors) and
# consecutive clean batches climb back to the healthy config; (3) deadline
# budgets — a request queued past its deadline_ms is shed with a typed
# DeadlineExceeded at batch formation instead of occupying a device slot.
# A dead worker thread flips health to readonly and fails every pending
# ticket fast (SchedulerUnhealthy) — no caller ever hangs on a dead engine.
print("\n=== fault injection + graceful degradation ===")
from repro_torch import faults
from repro_torch.serving import DeadlineExceeded

exact = db.dsq_batch(queries, scopes, k=3)       # fresh fault-free baseline
base = db.dsq_batch(queries, scopes, k=3, precision="int8")
plan = faults.FaultPlan(seed=0).add("store.host_fetch", kind="transient",
                                    count=2)
with faults.FaultInjector(plan) as inj:
    retried = db.dsq_batch(queries, scopes, k=3, precision="int8")
same = all(np.array_equal(r.ids[0], b.ids[0]) for r, b in zip(retried, base))
print(f"2 transient host-fetch faults absorbed by bounded retry: "
      f"bit-identical={same}, trips={inj.trips}, "
      f"retries counted={retried[0].batch.host_fetch_retries}")

fdsq = ScheduledDSQ(db, k=3, executor="flat", cfg=SchedulerConfig(
    max_batch=8, max_wait_ms=5.0,
    breaker_trip_after=2, breaker_reset_after=2))
with fdsq:
    with faults.FaultInjector(faults.FaultPlan(seed=0).add(
            "sched.execute", kind="error", count=2)):
        for _ in range(2):                 # two failed batches trip breaker
            try:
                fdsq.submit(queries[0], scopes[0]).result(timeout=30.0)
            except faults.FaultError:
                pass                       # typed — callers see the fault
    print(f"breaker tripped -> health={fdsq.health}, "
          f"level={fdsq.degrade_level}, precision={fdsq.precision}")
    degraded = [fdsq.submit(queries[i], scopes[i]).result(timeout=30.0)
                for i in range(4)]         # first served on the int8 rung
    print(f"degraded rung serves: recall@3 vs exact = "
          f"{recall(exact[:4], degraded):.2f}; after clean batches: "
          f"health={fdsq.health}, level={fdsq.degrade_level}, "
          f"precision={fdsq.precision}")
    try:                                   # exhausted budget -> typed shed
        fdsq.submit(queries[0], scopes[0], deadline_ms=0.0).result(timeout=30.0)
    except DeadlineExceeded as e:
        print(f"deadline shed is typed: {e}")
snap = fdsq.metrics.snapshot()
print(f"window: degrades={snap['degrades']}, recoveries={snap['recoveries']}, "
      f"failed={snap['failed']}, expired={snap['expired']}, "
      f"shed rate {snap['shed_rate']:.2f}")
