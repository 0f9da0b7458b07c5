"""Proximity-graph (PG) ANN executor — NSW-style beam search, mask-aware.

Mirrors the paper's graph-based executor behaviour under directory scoping:
the traversal navigates the *full* graph (connectivity must not depend on the
scope) but only scope-valid nodes are collected into the result set, so highly
selective scopes make the search do more traversal work per valid result —
exactly the PG latency-vs-depth trend of Fig. 11.

The port's copy of ``repro/vectordb/graph.py``: build, ``add``, ``repair``,
``audit``, ``remap_ids`` and the beam are the same numpy over the store's
host arrays, so the fp32 traversal repeats the reference bit for bit (RNG
draws included). The int8 and PQ searches end in the port's
:func:`~repro_torch.vectordb.flat.gather_rescore`, whose exact fp32 ranking
is the ``multi_scope_topk`` kernel on a card.
"""
from __future__ import annotations

import functools
import heapq
from typing import List, Optional, Tuple

import numpy as np

from .store import VectorStore


class PGIndex:
    name = "pg"

    def __init__(self, store: VectorStore, max_degree: int = 16,
                 ef_construction: int = 64, seed: int = 0):
        self.store = store
        self.max_degree = max_degree
        self.ef_construction = ef_construction
        n = len(store)
        self.neighbors = np.full((n, max_degree), -1, dtype=np.int32)
        self._n_edges = np.zeros(n, dtype=np.int32)
        self._rng = np.random.default_rng(seed)
        # generation-stamped visited buffer: one array reused by every _beam
        # call (build runs one beam per inserted node, so a fresh O(n)
        # allocation per call would make construction quadratic)
        self._visit_gen = np.zeros(n, dtype=np.int64)
        self._gen = 0
        # bumped by every completed repair() — the maintenance journal's
        # idempotence probe (did the crashed repair finish its relink pass?)
        self.repair_gen = 0
        # damage found by a budgeted repair() but deferred past its
        # max_relink slice; drained (ascending id order) by later slices
        self._pending_relink: List[int] = []
        self._build()
        # deterministic search entry (the node nearest the dataset centroid):
        # a fixed, central entry makes looped and batched searches identical
        # and removes per-query RNG draws from the hot path
        self._entry = 0
        if n:
            mu = store.vectors.mean(axis=0)
            self._entry = int(np.argmin(
                self._distances(mu, np.arange(n, dtype=np.int64))))

    # ------------------------------------------------------------------ build
    def _distances(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        rows = self.store.vectors[ids]
        if self.store.metric in ("ip", "cos"):
            return -(rows @ q)                       # smaller = closer
        diff = rows - q
        return np.einsum("nd,nd->n", diff, diff)

    def _distances_i8(self, q_i8f: np.ndarray, q_scale: float,
                      ids: np.ndarray) -> np.ndarray:
        """Quantized traversal distances: the int8 codes of the visited rows
        dot the quantized query (f32 arithmetic on integer values — exact,
        see ``flat._int_exact_dot``), scales multiplied back in. Ranking is
        what the beam needs, so l2 uses the same ``||q||^2``-free identity
        as the scan (plus the dequantized-row norms)."""
        rows = self.store.q_vectors[ids].astype(np.float32)
        s = (rows @ q_i8f) * (self.store.q_scales[ids] * q_scale)
        if self.store.metric in ("ip", "cos"):
            return -s
        return self.store.q_sq_norms()[ids] - 2.0 * s

    def _distances_pq(self, lut_q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """PQ/ADC traversal distances: sum each visited row's LUT entries
        (M byte-indexed lookups instead of a dim-wide fp32 dot). The LUT
        already folds the metric (see ``PQCodebook.lut``) into a
        larger-is-better score, so negate for the beam's smaller-is-closer
        ordering."""
        codes = self.store.pq_codes[ids]                    # (n, M)
        m = codes.shape[1]
        s = lut_q[np.arange(m)[None, :], codes.astype(np.int64)].sum(axis=1)
        return -s

    def _build(self) -> None:
        n = len(self.store)
        self._n_nodes = n
        if n == 0:
            return
        order = self._rng.permutation(n)
        inserted = [int(order[0])]
        for idx in order[1:]:
            idx = int(idx)
            cand, _ = self._beam(self.store.vectors[idx],
                                 entry=inserted[self._rng.integers(len(inserted))],
                                 ef=self.ef_construction,
                                 limit_ids=len(inserted), inserted=True)
            links = cand[: self.max_degree]
            for nb in links:
                self._connect(idx, int(nb))
            if self._n_edges[idx] == 0 and len(links):
                self._force_link(idx, int(links[0]))
            inserted.append(idx)

    # ------------------------------------------------------ incremental add
    def _grow(self, n: int) -> None:
        if n <= self.neighbors.shape[0]:
            return
        old = self.neighbors.shape[0]
        cap = max(n, 2 * old, 8)
        neighbors = np.full((cap, self.max_degree), -1, dtype=np.int32)
        neighbors[:old] = self.neighbors
        self.neighbors = neighbors
        n_edges = np.zeros(cap, dtype=np.int32)
        n_edges[:old] = self._n_edges
        self._n_edges = n_edges
        visit_gen = np.zeros(cap, dtype=np.int64)
        visit_gen[:old] = self._visit_gen
        self._visit_gen = visit_gen

    def add(self, ids: np.ndarray) -> None:
        """Incrementally link freshly-added store rows into the graph: beam
        search from the fixed entry point collects each new node's nearest
        linked neighbors, then connects both ways under ``max_degree``
        pruning (the same rule the bulk build applies). Without this, rows
        ingested after ``build_ann("pg")`` exist in the store but are
        unreachable through the graph."""
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) == 0:
            return
        self._grow(len(self.store))
        for idx in ids:
            idx = int(idx)
            if self._n_nodes == 0:
                self._entry = idx       # first node seeds the graph
                self._n_nodes = 1
                continue
            cand, _ = self._beam(self.store.vectors[idx], entry=self._entry,
                                 ef=self.ef_construction)
            for nb in cand[: self.max_degree]:
                self._connect(idx, int(nb))
            if self._n_edges[idx] == 0 and len(cand):
                self._force_link(idx, int(cand[0]))
            self._n_nodes += 1

    def _connect(self, a: int, b: int) -> None:
        """Link ``a <-> b`` as a symmetric pair, pruning each full row to its
        ``max_degree`` closest links. The adjacency is kept an *undirected*
        invariant: a neighbor pruned out of one row loses its reverse edge
        too, and the new edge survives only if it makes both rows. The old
        one-sided prune left the dropped neighbor's edge in place — under
        heavy ``add`` churn those one-way edges accumulate until beam
        traversal keeps walking into rows that no longer reciprocate
        (audited by :meth:`audit`, pinned by the directed-edge-symmetry
        property test)."""
        if a == b:
            return
        kept_a, dropped_a = self._prune_into(a, b)
        if not kept_a:
            # b never made a's row: no edge forms; only a's pruned old
            # neighbors (never b, it was rejected on entry) lose reverses
            for d in dropped_a:
                self._drop_edge(d, a)
            return
        kept_b, dropped_b = self._prune_into(b, a)
        if not kept_b:
            self._drop_edge(a, b)
        for d in dropped_a:
            self._drop_edge(d, a)
        for d in dropped_b:
            self._drop_edge(d, b)

    def _prune_into(self, a: int, b: int) -> Tuple[bool, Tuple[int, ...]]:
        """Insert ``b`` into ``a``'s row, pruning to the ``max_degree``
        closest. Returns ``(b_kept, dropped_old_neighbors)`` — the caller
        removes the dropped neighbors' reverse edges."""
        ne = self._n_edges[a]
        row = self.neighbors[a]
        if b in row[:ne]:
            return True, ()
        if ne < self.max_degree:
            row[ne] = b
            self._n_edges[a] = ne + 1
            return True, ()
        cand = np.concatenate([row[:ne], [b]])
        d = self._distances(self.store.vectors[a], cand)
        keep = cand[np.argsort(d, kind="stable")[: self.max_degree]]
        self.neighbors[a, : len(keep)] = keep
        self.neighbors[a, len(keep):] = -1
        self._n_edges[a] = len(keep)
        keep_set = set(int(x) for x in keep)
        dropped = tuple(int(x) for x in cand[:ne] if int(x) not in keep_set)
        return b in keep_set, dropped

    def _drop_edge(self, u: int, v: int) -> None:
        """Remove the directed edge ``u -> v`` if present (order-preserving
        row compaction)."""
        ne = self._n_edges[u]
        row = self.neighbors[u]
        pos = np.nonzero(row[:ne] == v)[0]
        if pos.size == 0:
            return
        p = int(pos[0])
        row[p: ne - 1] = row[p + 1: ne]
        row[ne - 1] = -1
        self._n_edges[u] = ne - 1

    def _force_link(self, a: int, b: int) -> None:
        """Minimum-connectivity fallback: guarantee the edge ``a <-> b``
        even when ``b``'s row is full and rejects ``a`` under distance
        pruning, by evicting ``b``'s farthest neighbor (reverse edge
        dropped too — symmetry holds). Without this a node whose every
        candidate neighbor prunes it away is left with zero edges:
        unreachable, silently invisible to every beam search."""
        if a == b or self._n_edges[a] >= self.max_degree:
            return
        ne = self._n_edges[b]
        row = self.neighbors[b]
        if a in row[:ne]:
            return
        if ne >= self.max_degree:
            d = self._distances(self.store.vectors[b], row[:ne])
            evict = int(row[int(np.argmax(d))])
            self._drop_edge(b, evict)
            self._drop_edge(evict, b)
            ne = self._n_edges[b]
        row[ne] = a
        self._n_edges[b] = ne + 1
        ra = self.neighbors[a]
        ra[self._n_edges[a]] = b
        self._n_edges[a] += 1

    # ------------------------------------------------------------ maintenance
    def audit(self) -> dict:
        """Edge-health census: directed edges whose reverse is missing
        (``asymmetric``), edges pointing at tombstoned rows (``dead``), and
        alive nodes left under half their degree budget (``underfilled``).
        The repair trigger reads these; the symmetry property test asserts
        ``asymmetric == 0`` after arbitrary add churn."""
        n = self._n_nodes
        alive = self.store.alive_bool()
        asym = dead = edges = underfilled = 0
        for a in range(n):
            row = self.neighbors[a][: self._n_edges[a]]
            edges += len(row)
            if alive is not None and not alive[a]:
                continue
            for b in row.tolist():
                if alive is not None and not alive[b]:
                    dead += 1
                elif a not in self.neighbors[b][: self._n_edges[b]]:
                    asym += 1
            live = (len(row) if alive is None
                    else int(np.count_nonzero(alive[row])))
            if live < self.max_degree // 2:
                underfilled += 1
        return {"nodes": n, "edges": edges, "asymmetric": asym,
                "dead": dead, "underfilled": underfilled}

    def repair(self, max_relink: Optional[int] = None) -> dict:
        """Neighborhood repair: drop edges into tombstoned rows (and any
        one-way edges from graphs built before the symmetric prune), then
        re-link every node the drop pass damaged — a fresh beam from the
        entry point reconnects it through alive neighborhoods, exactly like
        an insert. ``max_relink`` bounds the relink pass (the expensive
        part — one beam per damaged node) so a serving-slot repair is a
        bounded unit of work; ``remaining_damage`` in the result tells the
        caller to schedule another slice (damaged nodes are relinked in
        ascending id order, so slices are deterministic). Deterministic
        given (store/graph state, max_relink), so a crashed repair replays
        to the identical graph. Returns drop/relink counters; bumps
        :attr:`repair_gen` on completion of each slice."""
        n = self._n_nodes
        alive = self.store.alive_bool()
        cap = self.neighbors.shape[0]
        deg = self.max_degree
        in_row = np.arange(deg)[None, :] < self._n_edges[:, None]
        dropped = 0
        if alive is None:
            damaged = np.nonzero(self._n_edges[:n] == 0)[0].tolist()
        else:
            # vectorized drop pass: one packed rewrite of every adjacency
            # row (a per-node Python loop here would dominate the serving
            # slot at graph scale)
            arow = np.zeros(cap, dtype=bool)
            m = min(cap, len(alive))
            arow[:m] = alive[:m]
            safe = np.where(in_row, self.neighbors, 0).astype(np.int64)
            valid = in_row & arow[safe]
            valid[~arow] = False          # tombstoned node: disconnect
            order = np.argsort(~valid, axis=1, kind="stable")
            packed = np.take_along_axis(self.neighbors, order, axis=1)
            new_edges = valid.sum(axis=1).astype(np.int32)
            packed[np.arange(deg)[None, :] >= new_edges[:, None]] = -1
            dropped = int(in_row.sum() - valid.sum())
            changed = (new_edges != self._n_edges) | (new_edges == 0)
            self.neighbors = packed
            self._n_edges = new_edges
            damaged = np.nonzero(changed[:n] & arow[:n])[0].tolist()
        # asymmetry heal: re-reciprocate surviving one-way edges. The
        # membership test is vectorized over the whole directed edge set
        # (key = a * cap + b, reverse presence via np.isin) — a Python
        # per-edge `in` scan here would dominate the serving slot.
        healed = 0
        idx = np.nonzero(np.arange(deg)[None, :] < self._n_edges[:, None])
        if len(idx[0]):
            src = idx[0].astype(np.int64)
            dst = self.neighbors[idx].astype(np.int64)
            keys = src * cap + dst
            missing = ~np.isin(dst * cap + src, keys)
            for a, b in zip(src[missing].tolist(), dst[missing].tolist()):
                self._connect(int(a), int(b))
                healed += 1
        # entry must be alive or every search starts in a disconnected
        # tombstone; re-seed at the alive node nearest the alive centroid
        if n and alive is not None and not alive[self._entry]:
            ids = np.nonzero(alive[:n])[0]
            if len(ids):
                mu = self.store.vectors[ids].mean(axis=0)
                self._entry = int(ids[np.argmin(self._distances(mu, ids))])
        relinked = 0
        merged = sorted(set(self._pending_relink) | set(damaged))
        todo = merged if max_relink is None else merged[:max_relink]
        for a in todo:
            if self._n_nodes <= 1:
                break
            if alive is not None and (a >= len(alive) or not alive[a]):
                continue                  # deferred node tombstoned since
            cand, _ = self._beam(self.store.vectors[a], entry=self._entry,
                                 ef=self.ef_construction,
                                 valid_mask=alive)
            for nb in cand[: self.max_degree]:
                if int(nb) != a:
                    self._connect(a, int(nb))
            if self._n_edges[a] == 0:
                for nb in cand:
                    if int(nb) != a:
                        self._force_link(a, int(nb))
                        break
            relinked += 1
        self._pending_relink = [] if max_relink is None \
            else merged[max_relink:]
        self.repair_gen += 1
        return {"dropped_edges": dropped, "relinked_nodes": relinked,
                "healed_edges": healed,
                "remaining_damage": len(self._pending_relink)}

    def remap_ids(self, mapping) -> None:
        """Order-preserving id compaction: rewrite rows/edges into the new
        id space; tombstoned neighbors (mapped to -1) drop out of rows,
        tombstoned nodes drop out of the graph."""
        m = np.asarray(mapping, dtype=np.int64)
        old_n = min(self._n_nodes, len(m))
        cap = self.neighbors.shape[0]
        out = np.full((cap, self.max_degree), -1, dtype=np.int32)
        n_edges = np.zeros(cap, dtype=np.int32)
        for a in range(old_n):
            na = m[a]
            if na < 0:
                continue
            row = self.neighbors[a][: self._n_edges[a]]
            row = m[row]
            row = row[row >= 0]
            out[na, : len(row)] = row
            n_edges[na] = len(row)
        self.neighbors = out
        self._n_edges = n_edges
        self._n_nodes = int(np.count_nonzero(m >= 0))
        self._pending_relink = sorted(
            int(m[a]) for a in self._pending_relink
            if a < len(m) and m[a] >= 0)
        self._visit_gen = np.zeros(cap, dtype=np.int64)
        self._gen = 0
        if self._entry < len(m) and m[self._entry] >= 0:
            self._entry = int(m[self._entry])
        elif self._n_nodes:
            mu = self.store.vectors.mean(axis=0)
            ids = np.arange(self._n_nodes, dtype=np.int64)
            self._entry = int(np.argmin(self._distances(mu, ids)))

    # ----------------------------------------------------------------- search
    def _beam(self, q: np.ndarray, entry: int, ef: int,
              limit_ids: Optional[int] = None, inserted: bool = False,
              valid_mask: Optional[np.ndarray] = None, k: Optional[int] = None,
              dist_fn=None) -> Tuple[np.ndarray, int]:
        """Best-first beam search; returns (ids best-first, hops). When
        ``valid_mask`` is given, only valid ids enter the *result* heap but all
        nodes are traversable (mask-aware post-collection). Per-hop neighbor
        filtering and scoring are vectorized (visited is the reusable
        generation-stamped mask, distances one batched call per hop).
        ``dist_fn`` overrides the distance function (ids -> distances);
        the int8 search path passes the quantized-store scorer."""
        if dist_fn is None:
            dist_fn = lambda ids: self._distances(q, ids)
        self._gen += 1
        gen = self._gen
        visit_gen = self._visit_gen
        visit_gen[entry] = gen
        d0 = float(dist_fn(np.asarray([entry]))[0])
        frontier = [(d0, entry)]                       # min-heap by distance
        # result: max-heap of (−distance, id), only scope-valid ids
        result: list = []
        if valid_mask is None or valid_mask[entry]:
            result.append((-d0, entry))
        hops = 0
        target = ef if k is None else max(ef, k)
        while frontier:
            d, node = heapq.heappop(frontier)
            if result and len(result) >= target and d > -result[0][0]:
                break
            hops += 1
            nbrs = self.neighbors[node][: self._n_edges[node]]
            if limit_ids is not None and not inserted:
                nbrs = nbrs[nbrs < limit_ids]
            nbrs = nbrs[visit_gen[nbrs] != gen]
            if nbrs.size == 0:
                continue
            visit_gen[nbrs] = gen
            dists = dist_fn(nbrs)
            check = None if valid_mask is None else valid_mask[nbrs]
            for j, (nb, dist) in enumerate(zip(nbrs.tolist(), dists.tolist())):
                if (not result or len(result) < target
                        or dist < -result[0][0]):
                    heapq.heappush(frontier, (dist, nb))
                    if check is None or check[j]:
                        heapq.heappush(result, (-dist, nb))
                        if len(result) > target:
                            heapq.heappop(result)
        ordered = sorted(((-nd, i) for nd, i in result))
        return np.asarray([i for _, i in ordered], dtype=np.int64), hops

    def nbytes(self) -> int:
        return self.neighbors.nbytes + self._n_edges.nbytes

    def _valid_mask(self, candidate_ids: Optional[np.ndarray]
                    ) -> Optional[np.ndarray]:
        """Scope ∧ alive result-collection mask (None = everything valid)."""
        n = len(self.store)
        alive = self.store.alive_bool()
        if candidate_ids is None:
            return alive
        valid = np.zeros(n, dtype=bool)
        ids = np.asarray(candidate_ids, dtype=np.int64)
        valid[ids[ids < n]] = True
        if alive is not None:
            valid &= alive
        return valid

    def search(self, queries: np.ndarray, k: int,
               candidate_ids: Optional[np.ndarray] = None,
               ef_search: int = 64, precision: str = "fp32",
               rescore_k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        return self.search_batch(queries, k,
                                 valid_mask=self._valid_mask(candidate_ids),
                                 ef_search=ef_search, precision=precision,
                                 rescore_k=rescore_k)

    def search_batch(self, queries: np.ndarray, k: int,
                     valid_mask: Optional[np.ndarray] = None,
                     ef_search: int = 64, precision: str = "fp32",
                     rescore_k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched front door: one shared result-collection mask for the
        whole query batch (hoisted out of the per-query loop — dsq_batch
        passes each scope group's cached bool mask straight in).

        ``precision="int8"`` navigates the graph against the int8 codes
        (the traversal's row reads shrink 4x — the PG twin of the quantized
        scan) collecting ``max(ef_search, rescore_k)`` scope-valid
        candidates, then ranks the final top-k with the shared exact fp32
        gather-rescore."""
        from .quant import quantize_rows, resolve_rescore_k
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        nq = queries.shape[0]
        n = len(self.store)
        out_scores = np.full((nq, k), -np.inf, dtype=np.float32)
        out_ids = np.full((nq, k), -1, dtype=np.int64)
        if n == 0:
            return out_scores, out_ids
        if precision == "int8":
            from .flat import gather_rescore
            r = max(ef_search, resolve_rescore_k(k, rescore_k, n))
            q_i8, q_s = quantize_rows(queries)
            q_i8f = q_i8.astype(np.float32)
            cand = np.full((nq, r), -1, dtype=np.int64)
            for qi in range(nq):
                dist_fn = functools.partial(self._distances_i8, q_i8f[qi],
                                            float(q_s[qi]))
                ids, _ = self._beam(queries[qi], self._entry, r,
                                    valid_mask=valid_mask, k=k,
                                    dist_fn=dist_fn)
                ids = ids[:r]
                cand[qi, : len(ids)] = ids
            return gather_rescore(self.store, queries, cand, k)
        if precision == "pq":
            from .flat import gather_rescore
            r = max(ef_search, resolve_rescore_k(k, rescore_k, n))
            lut = self.store.pq_lut(queries)                # (nq, M, 256)
            cand = np.full((nq, r), -1, dtype=np.int64)
            for qi in range(nq):
                dist_fn = functools.partial(self._distances_pq, lut[qi])
                ids, _ = self._beam(queries[qi], self._entry, r,
                                    valid_mask=valid_mask, k=k,
                                    dist_fn=dist_fn)
                ids = ids[:r]
                cand[qi, : len(ids)] = ids
            return gather_rescore(self.store, queries, cand, k)
        for qi in range(nq):
            ids, _ = self._beam(queries[qi], self._entry, ef_search,
                                valid_mask=valid_mask, k=k)
            ids = ids[:k]
            if len(ids) == 0:
                continue
            rows = self.store.vectors[ids]
            if self.store.metric in ("ip", "cos"):
                scores = rows @ queries[qi]
            else:
                scores = 2.0 * rows @ queries[qi] - np.sum(rows * rows, axis=1)
            out_scores[qi, : len(ids)] = scores
            out_ids[qi, : len(ids)] = ids
        return out_scores, out_ids
