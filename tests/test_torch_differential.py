"""Cross-strategy / cross-executor differential fuzz harness, run on the
port (``repro_torch``); the twin of ``tests/test_differential.py``.

"Toward Understanding Bugs in Vector Database Management Systems"
(arXiv 2506.02617) finds the dominant VDBMS bug class is cross-component
inconsistency — exactly what three scope strategies × five executor paths ×
DSM mutation risk here. This harness is the consistency net: a seeded random
op sequence (ingest / mkdir / move / merge / rmdir / delete / dsq /
dsq_batch / crash+recover) executes against all three strategies (PE-Online,
PE-Offline, TrieHI) and, at checkpoints, every executor path (flat loop,
flat batch, sharded batch, ivf device+loop, pg) — verified against a naive
pure-Python oracle and against each other:

* strategies must agree *exactly* with each other and with the oracle on
  every resolved scope (rmdir removal sets included);
* flat / sharded results must match the oracle's exact top-k (score parity,
  tie-tolerant id sets) and each other bit-for-bit (``dsq`` and
  ``dsq_batch``; the port's sharded tier runs the flat launch's chains per
  shard and merges stably, so it holds this where the reference drifts by
  an ulp);
* ivf's device path must match its per-query loop oracle, and every
  approximate result (ivf, pg) must stay inside the oracle scope with
  correctly-computed scores;
* crash+recover replays a journaled-but-unapplied op (BEGIN without COMMIT,
  i.e. a crash between journal append and mutation) and the recovered state
  must equal the oracle's post-op state.

Every database is built with ``device="cpu"`` (the plain PyTorch versions
of the kernels); ``tests/test_torch_gpu.py`` runs the same fuzz on a card.
"""
import os
import tempfile
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import pytest

from repro_torch.core import DSM, STRATEGIES
from repro_torch.core import paths as P
from repro_torch.vectordb import DirectoryVectorDB, MaintenancePolicy

DIM = 16
K = 5
NPROBE = 4
EF = 48


# ------------------------------------------------------------------- oracle
class PyOracle:
    """Naive pure-Python model of DirectoryVectorDB's directory semantics:
    a flat {entry_id -> directory path} map plus a directory set, mutated by
    prefix rewriting. Deliberately structure-free — no tries, postings or
    bitmaps — so it cannot share a bug with any strategy."""

    def __init__(self):
        self.dirs: Set[Tuple[str, ...]] = {()}
        self.entries: Dict[int, Tuple[str, ...]] = {}
        self.vectors: Dict[int, np.ndarray] = {}

    def _add_dir(self, p: Tuple[str, ...]) -> None:
        for i in range(len(p) + 1):
            self.dirs.add(p[:i])

    def ingest(self, ids, vectors, paths) -> None:
        for eid, vec, path in zip(ids, vectors, paths):
            pt = P.parse(path)
            self._add_dir(pt)
            self.entries[int(eid)] = pt
            self.vectors[int(eid)] = np.asarray(vec, np.float32)

    def mkdir(self, path) -> None:
        self._add_dir(P.parse(path))

    def delete(self, eid: int) -> None:
        self.entries.pop(int(eid), None)

    @staticmethod
    def _under(d: Tuple[str, ...], p: Tuple[str, ...]) -> bool:
        return d[: len(p)] == p

    def _rekey(self, old: Tuple[str, ...], new: Tuple[str, ...]) -> None:
        self.dirs = {new + d[len(old):] if self._under(d, old) else d
                     for d in self.dirs}
        for eid, d in list(self.entries.items()):
            if self._under(d, old):
                self.entries[eid] = new + d[len(old):]

    def move(self, src, new_parent) -> None:
        s, npar = P.parse(src), P.parse(new_parent)
        self._add_dir(npar)
        self._rekey(s, npar + (s[-1],))

    def merge(self, src, dst) -> None:
        self._rekey(P.parse(src), P.parse(dst))

    def remove(self, path) -> Set[int]:
        p = P.parse(path)
        removed = {eid for eid, d in self.entries.items()
                   if self._under(d, p)}
        for eid in removed:
            del self.entries[eid]
        self.dirs = {d for d in self.dirs if not self._under(d, p)}
        return removed

    def resolve(self, path, recursive=True, exclude=()) -> Set[int]:
        p = P.parse(path)
        if recursive:
            ids = {eid for eid, d in self.entries.items()
                   if self._under(d, p)}
        else:
            ids = {eid for eid, d in self.entries.items() if d == p}
        for ex in exclude:
            e = P.parse(ex)
            ids -= {eid for eid, d in self.entries.items()
                    if self._under(d, e)}
        return ids

    def scores(self, q: np.ndarray, ids) -> Dict[int, float]:
        return {eid: float(self.vectors[eid] @ q.astype(np.float32))
                for eid in ids}

    def topk(self, q: np.ndarray, scope: Set[int], k: int
             ) -> List[Tuple[int, float]]:
        sc = self.scores(q, scope)
        return sorted(sc.items(), key=lambda t: (-t[1], t[0]))[:k]


# ---------------------------------------------------------------- generator
class FuzzState:
    def __init__(self, seed: int, tmpdir: str, device: str = "cpu"):
        self.rng = np.random.default_rng(seed)
        self.oracle = PyOracle()
        self.dbs: Dict[str, DirectoryVectorDB] = {}
        for strat in STRATEGIES:
            self.dbs[strat] = DirectoryVectorDB(
                dim=DIM, scope_strategy=strat, device=device,
                journal_path=os.path.join(tmpdir, f"journal.{strat}"))
        self.alive: List[int] = []
        # one shared policy object so db.maintenance() reuses its manager;
        # low thresholds make every op kind reachable at fuzz scale
        self._maint_policy = MaintenancePolicy(
            tombstone_min=8, tombstone_fraction=0.05,
            pad_waste_min=32, pad_waste_fraction=0.10,
            repair_deletes=4, n_iters=2, sample=64)

    # -- helpers ----------------------------------------------------------
    def _dirs(self, non_root=False) -> List[Tuple[str, ...]]:
        ds = sorted(self.oracle.dirs)
        return [d for d in ds if d] if non_root else ds

    def _pick_dir(self, non_root=False) -> Optional[Tuple[str, ...]]:
        ds = self._dirs(non_root)
        if not ds:
            return None
        return ds[int(self.rng.integers(len(ds)))]

    # -- ops --------------------------------------------------------------
    def op_ingest(self, n: Optional[int] = None) -> None:
        n = n or int(self.rng.integers(1, 9))
        dirs = self._dirs()
        paths = [P.to_str(dirs[int(self.rng.integers(len(dirs)))])
                 for _ in range(n)]
        vecs = self.rng.normal(size=(n, DIM)).astype(np.float32)
        ids = None
        for db in self.dbs.values():
            got = db.ingest(vecs, paths)
            assert ids is None or np.array_equal(ids, got)
            ids = got
        self.oracle.ingest(ids, vecs, paths)
        self.alive.extend(int(i) for i in ids)

    def op_mkdir(self) -> None:
        parent = self._pick_dir()
        name = f"n{int(self.rng.integers(1 << 30))}"
        path = P.to_str(parent + (name,))
        for db in self.dbs.values():
            db.mkdir(path)
        self.oracle.mkdir(path)

    def op_move(self) -> bool:
        for _ in range(20):
            src = self._pick_dir(non_root=True)
            npar = self._pick_dir()
            if src is None or npar is None:
                return False
            if P.is_ancestor(src, npar) or npar[: len(src)] == src:
                continue
            if npar + (src[-1],) in self.oracle.dirs:
                continue             # dest name conflict: move() rejects
            if npar == src[:-1]:
                continue             # no-op move to own parent
            for db in self.dbs.values():
                db.move(P.to_str(src), P.to_str(npar))
            self.oracle.move(P.to_str(src), P.to_str(npar))
            return True
        return False

    def op_merge(self) -> bool:
        for _ in range(20):
            src = self._pick_dir(non_root=True)
            dst = self._pick_dir(non_root=True)
            if src is None or dst is None:
                return False
            if src == dst or self.oracle._under(src, dst) \
                    or self.oracle._under(dst, src):
                continue
            for db in self.dbs.values():
                db.merge(P.to_str(src), P.to_str(dst))
            self.oracle.merge(P.to_str(src), P.to_str(dst))
            return True
        return False

    def op_rmdir(self) -> bool:
        src = self._pick_dir(non_root=True)
        if src is None:
            return False
        removed_sets = []
        for db in self.dbs.values():
            removed_sets.append(
                {int(i) for i in db.rmdir(P.to_str(src))})
        want = self.oracle.remove(P.to_str(src))
        for got in removed_sets:
            assert got == want, (got, want)
        self.alive = [i for i in self.alive if i not in want]
        return True

    def op_delete(self) -> bool:
        if not self.alive:
            return False
        eid = self.alive.pop(int(self.rng.integers(len(self.alive))))
        for db in self.dbs.values():
            db.delete(eid)
        self.oracle.delete(eid)
        return True

    def op_maintenance(self) -> bool:
        """Online maintenance differential: every strategy DB saw identical
        churn, so due() and each journaled op (PG repair, compaction,
        seeded repartition) must run identically on all three — and the
        compaction's order-preserving id remap must rekey the oracle to
        exactly the ids the DBs now return."""
        first = next(iter(self.dbs.values()))
        if not first.executors:
            return False                   # pre-build_ann: nothing to repair
        n = len(first.store)
        alive_b = first.store.alive_bool()
        ran: Optional[List[str]] = None
        for strat, db in self.dbs.items():
            mgr = db.maintenance(policy=self._maint_policy)
            kinds = [r["kind"] for r in mgr.run_all()]
            assert ran is None or kinds == ran, (strat, kinds, ran)
            assert mgr.stats()["journal_pending"] == 0, strat
            ran = kinds
        if ran and "maint_compact" in ran:
            # ids are store rows and compaction slides alive rows down in
            # order, so the mapping is computable from the pre-op alive set
            alive_rows = (np.nonzero(alive_b)[0] if alive_b is not None
                          else np.arange(n))
            mapping = np.full(n, -1, np.int64)
            mapping[alive_rows] = np.arange(len(alive_rows))
            self.oracle.entries = {int(mapping[e]): d for e, d
                                   in self.oracle.entries.items()}
            self.oracle.vectors = {int(mapping[e]): v for e, v
                                   in self.oracle.vectors.items()}
            self.alive = [int(mapping[i]) for i in self.alive]
            assert all(i >= 0 for i in self.alive)
        return bool(ran)

    def op_crash_recover(self) -> None:
        """recover() on a healthy journal must replay nothing and leave
        every invariant intact."""
        for db in self.dbs.values():
            replayed = db.recover()
            assert all(not ops for ops in replayed.values()), replayed
            db.check_invariants()

    def random_scope(self) -> Tuple[str, bool, List[str]]:
        anchor = self._pick_dir() or ()
        recursive = bool(self.rng.random() < 0.8)
        exclude: List[str] = []
        if recursive and self.rng.random() < 0.3:
            subs = [d for d in self._dirs(non_root=True)
                    if self.oracle._under(d, anchor) and d != anchor]
            if subs:
                exclude = [P.to_str(subs[int(self.rng.integers(len(subs)))])]
        return P.to_str(anchor), recursive, exclude

    # -- checks -----------------------------------------------------------
    def check_dsq(self) -> None:
        q = self.rng.normal(size=DIM).astype(np.float32)
        path, rec, exc = self.random_scope()
        scope = self.oracle.resolve(path, rec, exc)
        want = self.oracle.topk(q, scope, K)
        per_exec: Dict[str, list] = {}
        for strat, db in self.dbs.items():
            raw = {}
            for name, params in (("flat", {}), ("sharded", {}),
                                 ("ivf", {"nprobe": NPROBE}),
                                 ("pg", {"ef_search": EF})):
                res = db.dsq(q, path, k=K, recursive=rec, exclude=exc,
                             executor=name, **params)
                raw[name] = res
                ids = [int(i) for i in res.ids[0] if int(i) >= 0]
                scores = [float(s) for s, i in zip(res.scores[0], res.ids[0])
                          if int(i) >= 0]
                assert res.scope_size == len(scope), (strat, name)
                # every id is in the oracle scope, with the right score
                assert set(ids) <= scope, (strat, name, set(ids) - scope)
                osc = self.oracle.scores(q, ids)
                for i, s in zip(ids, scores):
                    assert abs(osc[i] - s) < 1e-4 * max(1.0, abs(s)), \
                        (strat, name, i, s, osc[i])
                # strategies must agree exactly, per executor
                prev = per_exec.setdefault(name, [ids, scores])
                assert prev[0] == ids, (name, strat, prev[0], ids)
                np.testing.assert_allclose(prev[1], scores, rtol=1e-6,
                                           atol=1e-6, err_msg=f"{name}")
            # the port's sharded tier equals its flat executor bit for bit
            np.testing.assert_array_equal(raw["sharded"].ids, raw["flat"].ids)
            np.testing.assert_array_equal(raw["sharded"].scores,
                                          raw["flat"].scores)
            # exact executors must return the oracle's exact top-k
            # (tie-tolerant: a swapped id is fine if its score ties)
            for name in ("flat", "sharded"):
                ids, scores = per_exec[name]
                want_ids = {i for i, _ in want}
                for miss in want_ids - set(ids):
                    tie = min(scores) if scores else -np.inf
                    assert abs(dict(want)[miss] - tie) < 1e-5, \
                        (name, miss, dict(want)[miss], tie)
                np.testing.assert_allclose(
                    sorted(scores, reverse=True),
                    [s for _, s in want[: len(scores)]],
                    rtol=1e-5, atol=1e-5)
            # ivf device path vs its per-query loop oracle
            ivf = self.dbs[strat].executors["ivf"]
            cand = np.asarray(sorted(scope), dtype=np.uint32)
            ls, li = ivf.search_loop(q[None, :], K, candidate_ids=cand,
                                     nprobe=NPROBE)
            loop_ids = {int(i) for i in li[0] if int(i) >= 0}
            assert loop_ids == set(per_exec["ivf"][0]), (
                strat, loop_ids, per_exec["ivf"][0])

    def check_dsq_int8(self) -> None:
        """int8 executor rows: with ``rescore_k`` covering the whole store
        the exact fp32 rescore is exhaustive over the int8 phase's
        survivors, so the exact executors (flat, sharded) must reproduce
        the oracle's top-k *set* (k-boundary score ties tolerated — the
        quantization tolerance of the contract), the ivf int8 path must
        match its own fp32 top-k set, and every executor's returned scores
        must be true fp32 scores of in-scope ids."""
        q = self.rng.normal(size=DIM).astype(np.float32)
        path, rec, exc = self.random_scope()
        scope = self.oracle.resolve(path, rec, exc)
        want = self.oracle.topk(q, scope, K)
        k_max = max(len(self.oracle.vectors), 1)
        for strat, db in self.dbs.items():
            for name, params in (("flat", {}), ("sharded", {}),
                                 ("ivf", {"nprobe": NPROBE}),
                                 ("pg", {"ef_search": EF})):
                res = db.dsq(q, path, k=K, recursive=rec, exclude=exc,
                             executor=name, precision="int8",
                             rescore_k=k_max, **params)
                ids = [int(i) for i in res.ids[0] if int(i) >= 0]
                scores = [float(s) for s, i in
                          zip(res.scores[0], res.ids[0]) if int(i) >= 0]
                assert res.scope_size == len(scope), (strat, name)
                assert set(ids) <= scope, (strat, name, set(ids) - scope)
                osc = self.oracle.scores(q, ids)
                for i, s in zip(ids, scores):
                    assert abs(osc[i] - s) < 1e-4 * max(1.0, abs(s)), \
                        (strat, name, i, s, osc[i])
                if name in ("flat", "sharded"):
                    want_ids = {i for i, _ in want}
                    for miss in want_ids - set(ids):
                        tie = min(scores) if scores else -np.inf
                        assert abs(dict(want)[miss] - tie) < 1e-4, \
                            (strat, name, miss, dict(want)[miss], tie)
                if name == "ivf":
                    rf = db.dsq(q, path, k=K, recursive=rec, exclude=exc,
                                executor="ivf", **params)
                    f_ids = {int(i) for i in rf.ids[0] if int(i) >= 0}
                    f_sc = {int(i): float(s) for s, i in
                            zip(rf.scores[0], rf.ids[0]) if int(i) >= 0}
                    for miss in f_ids - set(ids):
                        tie = min(scores) if scores else -np.inf
                        assert abs(f_sc[miss] - tie) < 1e-4, \
                            (strat, miss, f_sc[miss], tie)

    def check_dsq_batch_int8(self) -> None:
        """int8 batch == int8 loop per executor (top-k sets + fp32 scores;
        the fp32 leg of :meth:`check_dsq_batch` keeps its bit-identity)."""
        B = 6
        qs = self.rng.normal(size=(B, DIM)).astype(np.float32)
        specs = [self.random_scope() for _ in range(B)]
        paths = [s[0] for s in specs]
        rec = [s[1] for s in specs]
        exc = [s[2] for s in specs]
        k_max = max(len(self.oracle.vectors), 1)
        for strat, db in self.dbs.items():
            for name, params in (("flat", {}), ("sharded", {}),
                                 ("ivf", {"nprobe": NPROBE}),
                                 ("pg", {"ef_search": EF})):
                batch = db.dsq_batch(qs, paths, k=K, recursive=rec,
                                     exclude=exc, executor=name,
                                     precision="int8", rescore_k=k_max,
                                     **params)
                for i, res in enumerate(batch):
                    loop = db.dsq(qs[i], paths[i], k=K, recursive=rec[i],
                                  exclude=exc[i], executor=name,
                                  precision="int8", rescore_k=k_max,
                                  **params)
                    got = {int(x) for x in res.ids[0] if int(x) >= 0}
                    ref = {int(x) for x in loop.ids[0] if int(x) >= 0}
                    if name == "pg":
                        # quantized beam traversal order is entry-dependent;
                        # assert scope membership + fp32 scores only
                        scope = self.oracle.resolve(paths[i], rec[i], exc[i])
                        assert got <= scope, (strat, i, got - scope)
                        continue
                    assert got == ref, (strat, name, i, got, ref)
                    np.testing.assert_allclose(
                        np.sort(res.scores[0][np.isfinite(res.scores[0])]),
                        np.sort(loop.scores[0][np.isfinite(loop.scores[0])]),
                        rtol=1e-5, atol=1e-5,
                        err_msg=f"int8/{strat}/{name}/{i}")

    def check_dsq_pq(self) -> None:
        """PQ executor rows, same contract as :meth:`check_dsq_int8`: with
        exhaustive ``rescore_k`` the exact fp32 rescore ranks every PQ-phase
        survivor, so flat/sharded must reproduce the oracle's top-k set
        (k-boundary ties tolerated), ivf-pq must match its own fp32 top-k
        set, and all returned scores are true fp32 scores of in-scope ids.
        Running after the fuzz's DSM/ingest ops also exercises the frozen
        codebook's incremental encode consistency."""
        q = self.rng.normal(size=DIM).astype(np.float32)
        path, rec, exc = self.random_scope()
        scope = self.oracle.resolve(path, rec, exc)
        want = self.oracle.topk(q, scope, K)
        k_max = max(len(self.oracle.vectors), 1)
        for strat, db in self.dbs.items():
            for name, params in (("flat", {}), ("sharded", {}),
                                 ("ivf", {"nprobe": NPROBE}),
                                 ("pg", {"ef_search": EF})):
                res = db.dsq(q, path, k=K, recursive=rec, exclude=exc,
                             executor=name, precision="pq",
                             rescore_k=k_max, **params)
                ids = [int(i) for i in res.ids[0] if int(i) >= 0]
                scores = [float(s) for s, i in
                          zip(res.scores[0], res.ids[0]) if int(i) >= 0]
                assert res.scope_size == len(scope), (strat, name)
                assert set(ids) <= scope, (strat, name, set(ids) - scope)
                osc = self.oracle.scores(q, ids)
                for i, s in zip(ids, scores):
                    assert abs(osc[i] - s) < 1e-4 * max(1.0, abs(s)), \
                        (strat, name, i, s, osc[i])
                if name in ("flat", "sharded"):
                    want_ids = {i for i, _ in want}
                    for miss in want_ids - set(ids):
                        tie = min(scores) if scores else -np.inf
                        assert abs(dict(want)[miss] - tie) < 1e-4, \
                            (strat, name, miss, dict(want)[miss], tie)
                if name == "ivf":
                    rf = db.dsq(q, path, k=K, recursive=rec, exclude=exc,
                                executor="ivf", **params)
                    f_ids = {int(i) for i in rf.ids[0] if int(i) >= 0}
                    f_sc = {int(i): float(s) for s, i in
                            zip(rf.scores[0], rf.ids[0]) if int(i) >= 0}
                    for miss in f_ids - set(ids):
                        tie = min(scores) if scores else -np.inf
                        assert abs(f_sc[miss] - tie) < 1e-4, \
                            (strat, miss, f_sc[miss], tie)

    def check_dsq_batch_pq(self) -> None:
        """pq batch == pq loop per executor (PG excepted: the quantized beam
        traversal is entry-dependent, so scope membership only)."""
        B = 6
        qs = self.rng.normal(size=(B, DIM)).astype(np.float32)
        specs = [self.random_scope() for _ in range(B)]
        paths = [s[0] for s in specs]
        rec = [s[1] for s in specs]
        exc = [s[2] for s in specs]
        k_max = max(len(self.oracle.vectors), 1)
        for strat, db in self.dbs.items():
            for name, params in (("flat", {}), ("sharded", {}),
                                 ("ivf", {"nprobe": NPROBE}),
                                 ("pg", {"ef_search": EF})):
                batch = db.dsq_batch(qs, paths, k=K, recursive=rec,
                                     exclude=exc, executor=name,
                                     precision="pq", rescore_k=k_max,
                                     **params)
                for i, res in enumerate(batch):
                    loop = db.dsq(qs[i], paths[i], k=K, recursive=rec[i],
                                  exclude=exc[i], executor=name,
                                  precision="pq", rescore_k=k_max,
                                  **params)
                    got = {int(x) for x in res.ids[0] if int(x) >= 0}
                    ref = {int(x) for x in loop.ids[0] if int(x) >= 0}
                    if name == "pg":
                        scope = self.oracle.resolve(paths[i], rec[i], exc[i])
                        assert got <= scope, (strat, i, got - scope)
                        continue
                    assert got == ref, (strat, name, i, got, ref)
                    np.testing.assert_allclose(
                        np.sort(res.scores[0][np.isfinite(res.scores[0])]),
                        np.sort(loop.scores[0][np.isfinite(loop.scores[0])]),
                        rtol=1e-5, atol=1e-5,
                        err_msg=f"pq/{strat}/{name}/{i}")

    def check_dsq_batch(self) -> None:
        B = 6
        qs = self.rng.normal(size=(B, DIM)).astype(np.float32)
        specs = [self.random_scope() for _ in range(B)]
        paths = [s[0] for s in specs]
        rec = [s[1] for s in specs]
        exc = [s[2] for s in specs]
        for strat, db in self.dbs.items():
            batches = {}
            for name, params in (("flat", {}), ("sharded", {}),
                                 ("ivf", {"nprobe": NPROBE}),
                                 ("pg", {"ef_search": EF})):
                batch = db.dsq_batch(qs, paths, k=K, recursive=rec,
                                     exclude=exc, executor=name, **params)
                batches[name] = batch
                for i, res in enumerate(batch):
                    loop = db.dsq(qs[i], paths[i], k=K, recursive=rec[i],
                                  exclude=exc[i], executor=name, **params)
                    got = {int(x) for x in res.ids[0] if int(x) >= 0}
                    ref = {int(x) for x in loop.ids[0] if int(x) >= 0}
                    assert got == ref, (strat, name, i, got, ref)
                    np.testing.assert_allclose(
                        np.sort(res.scores[0][np.isfinite(res.scores[0])]),
                        np.sort(loop.scores[0][np.isfinite(loop.scores[0])]),
                        rtol=1e-5, atol=1e-5,
                        err_msg=f"{strat}/{name}/{i}")
                if name in ("flat", "sharded"):
                    # batch must be *bit*-identical to the loop here
                    for i, res in enumerate(batch):
                        loop = db.dsq(qs[i], paths[i], k=K,
                                      recursive=rec[i], exclude=exc[i],
                                      executor=name)
                        np.testing.assert_array_equal(res.ids, loop.ids)
                        np.testing.assert_array_equal(res.scores,
                                                      loop.scores)
            # sharded batch == flat batch, bit for bit
            for sh, fl in zip(batches["sharded"], batches["flat"]):
                np.testing.assert_array_equal(sh.ids, fl.ids)
                np.testing.assert_array_equal(sh.scores, fl.scores)


WEIGHTS = [("ingest", 0.22), ("mkdir", 0.12), ("move", 0.14),
           ("merge", 0.10), ("rmdir", 0.07), ("delete", 0.10),
           ("crash_recover", 0.05), ("maintenance", 0.06),
           ("noop", 0.14)]


def _seed_corpus(state: FuzzState) -> None:
    """A real tree (depth >= 3) plus enough entries to build ANN on."""
    for _ in range(8):
        state.op_mkdir()
    state.op_ingest(48)
    for _ in range(4):
        state.op_mkdir()
    state.op_ingest(24)


def _run_fuzz(state: FuzzState, n_ops: int, check_every: int = 6) -> None:
    _seed_corpus(state)
    for db in state.dbs.values():
        db.build_ann("flat")
        db.build_ann("sharded")
        db.build_ann("ivf", n_lists=8)
        db.build_ann("pg", max_degree=8, ef_construction=24)
    kinds = [k for k, _ in WEIGHTS]
    probs = np.asarray([w for _, w in WEIGHTS])
    probs /= probs.sum()
    for step in range(n_ops):
        kind = kinds[int(state.rng.choice(len(kinds), p=probs))]
        getattr(state, f"op_{kind}", lambda: None)()
        for db in state.dbs.values():
            db.check_invariants()
        if (step + 1) % check_every == 0:
            state.check_dsq()
    state.check_dsq()
    state.check_dsq_batch()
    state.check_dsq_int8()
    state.check_dsq_batch_int8()
    state.check_dsq_pq()
    state.check_dsq_batch_pq()
    state.op_crash_recover()


def run_fuzz_seed(seed: int, device: str = "cpu") -> None:
    """The fuzz of :func:`test_differential_fuzz` on ``device`` (the card's
    twin in ``tests/test_torch_gpu.py`` passes ``"cuda"``)."""
    with tempfile.TemporaryDirectory() as tmp:
        state = FuzzState(seed, tmp, device=device)
        _run_fuzz(state, n_ops=30)


@pytest.mark.parametrize("seed", [0, 1])
def test_differential_fuzz(seed):
    run_fuzz_seed(seed)


def test_differential_crash_replay():
    """crash+recover differential: journal a DSM BEGIN without applying it
    (the crash window between append and mutation), reopen-free recover()
    must roll it forward on every strategy to exactly the oracle's state."""
    with tempfile.TemporaryDirectory() as tmp:
        state = FuzzState(seed=42, tmpdir=tmp)
        _seed_corpus(state)
        for db in state.dbs.values():
            db.build_ann("flat")
            db.build_ann("sharded")
            db.build_ann("ivf", n_lists=8)
            db.build_ann("pg", max_degree=8, ef_construction=24)
        # pick a valid move from current oracle state
        for _ in range(50):
            src = state._pick_dir(non_root=True)
            npar = state._pick_dir()
            if (src and npar is not None
                    and not P.is_ancestor(src, npar)
                    and npar[: len(src)] != src
                    and npar + (src[-1],) not in state.oracle.dirs
                    and npar != src[:-1]):
                break
        else:
            pytest.skip("no valid move found")
        op = DSM("move", P.to_str(src), P.to_str(npar))
        for strat, db in state.dbs.items():
            db._dsm["fs"].journal.begin(op)       # BEGIN, no COMMIT: "crash"
            replayed = db.recover()
            assert [o.src for o in replayed["fs"]] == [op.src], strat
            db.check_invariants()
        state.oracle.move(op.src, op.dst)
        state.check_dsq()
        state.check_dsq_batch()


def test_oracle_self_consistency():
    """The oracle's own prefix semantics (sanity for the net itself)."""
    o = PyOracle()
    o.ingest([0, 1, 2], np.eye(3, DIM, dtype=np.float32),
             ["/a/", "/a/b/", "/c/"])
    assert o.resolve("/a/") == {0, 1}
    assert o.resolve("/a/", recursive=False) == {0}
    assert o.resolve("/", exclude=["/a/b/"]) == {0, 2}
    o.move("/a/b/", "/c/")
    assert o.resolve("/c/") == {1, 2}
    o.merge("/c/", "/a/")
    assert o.resolve("/a/") == {0, 1, 2}
    assert o.remove("/a/") == {0, 1, 2}
    assert o.entries == {}


@pytest.mark.parametrize("seed", [3])
def test_differential_fuzz_perturbed_artifact(seed):
    """Differential fuzz under a randomly-perturbed calibration artifact:
    measured decisions (crossover threshold, rescore factor, precision
    flips, kernel block shapes, nprobe default) may change *plans*, but the
    recall/consistency gates above must hold for ANY artifact — the clamp
    envelope in CostModel is what makes perturbation safe. All three
    strategy DBs share one model, so cross-strategy bit-identity holds."""
    from repro_torch.kernels import ops as kops
    from repro_torch.vectordb.costmodel import (TUNABLE_KERNELS,
                                                install_kernel_tuning,
                                                resolve_calibration)
    rng = np.random.default_rng(seed)

    def term():
        return {"a": float(rng.uniform(0, 2e5)),
                "per_byte": float(rng.uniform(0, 5))}

    art = {
        "schema_version": 1, "backend": "cpu", "dim": DIM,
        "terms": {
            "gather_threshold": float(rng.uniform(0.0, 0.6)),
            "rescore_factor": int(rng.integers(1, 9)),
            "nprobe": {"default": int(rng.integers(1, 64))},
            "scan_ns": {p: term() for p in ("fp32", "int8", "pq")},
            "gather_ns": {"a": float(rng.uniform(0, 2e5)),
                          "per_row": float(rng.uniform(0, 2e3))},
            "rescore_ns": {"a": float(rng.uniform(0, 2e5)),
                           "per_row": float(rng.uniform(0, 2e3))},
            "kernel_blocks": {
                name: {"block_q": int(rng.choice([2, 4, 8, 16])),
                       "block_n": int(rng.choice([64, 128, 256, 512,
                                                  1024])),
                       "us": 1.0}
                for name in TUNABLE_KERNELS},
            "scheduler": {"max_batch": int(rng.integers(1, 64)),
                          "max_wait_ms": float(rng.uniform(0.5, 8.0)),
                          "service_us": {}},
        },
    }
    model = resolve_calibration(art, device="cpu")
    assert model.source == "measured"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            state = FuzzState(seed, tmp)
            for db in state.dbs.values():
                db.store.cost_model = model
            install_kernel_tuning(model)
            _run_fuzz(state, n_ops=18)
    finally:
        kops.set_block_overrides({})
