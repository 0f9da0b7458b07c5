"""Directory-scoped RAG / agent-context serving (the OpenViking deployment of
§IV-C), the port of ``repro/serving/rag.py``.

Pipeline per request batch:
  1. DSQ: TrieHI resolves the ``viking://``-style directory scope (recursive
     or not, with exclusions) to a candidate entry set.
  2. Scoped vector ranking inside the candidate set (tiered L0/L1/L2 entries
     share the directory scope; budget picks the tier).
  3. Context assembly under a token budget (L0 abstracts first, escalate to
     L2 bodies only for the top hits — OpenViking's tiered context loading).
  4. Batched LM decode over the assembled contexts: prefill, then greedy
     ``decode_step``s whose attention is kernel 10 on a card.

DSM ops (memory consolidation, subtree reorganization) run against the same
database between serving steps. Besides the synchronous ``retrieve_batch``
and ``answer``, the continuous-batching surface (``start_serving`` /
``submit_retrieve`` and ``RAGServer.start`` / ``submit``) coalesces
concurrent requests through :mod:`.scheduler`; a served answer batch
decodes on the scheduler's executing thread with the same kernel-10
launches as ``answer``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import decode_step, prefill
from ..vectordb import DirectoryVectorDB
from .scheduler import (ContinuousScheduler, ScheduledDSQ, SchedulerConfig,
                        ServingTicket, StagedQueries, assemble_dsq, stage_dsq)

TIERS = ("L0", "L1", "L2")


@dataclasses.dataclass
class ContextEntry:
    entry_id: int
    path: str
    tier: str
    text_tokens: np.ndarray          # pre-tokenized payload


@dataclasses.dataclass
class RAGConfig:
    k: int = 10
    token_budget: int = 512
    escalate_top: int = 3            # top hits get L2 bodies
    executor: str = "flat"
    precision: str = "fp32"          # "int8"/"pq": two-phase approx ranking
    rescore_k: Optional[int] = None  # approx-phase candidates (default 4k)


class ContextDatabase:
    """Tiered directory-scoped context store (OpenViking-style). ``device``
    holds the database's device state (``None`` = ``"cuda"``; without a
    card only ``device="cpu"`` runs)."""

    def __init__(self, dim: int, scope_strategy: str = "triehi",
                 calibration=None, device=None):
        self.db = DirectoryVectorDB(dim=dim, scope_strategy=scope_strategy,
                                    calibration=calibration, device=device)
        self._serving: Optional[ScheduledDSQ] = None
        self.payloads: Dict[int, ContextEntry] = {}

    def add_context(self, vector: np.ndarray, path: str, tier: str,
                    text_tokens: np.ndarray) -> int:
        if tier not in TIERS:
            raise ValueError(f"tier {tier!r} not in {TIERS}")
        (eid,) = self.db.ingest(vector[None, :], [path])
        self.payloads[int(eid)] = ContextEntry(int(eid), path, tier,
                                               np.asarray(text_tokens))
        return int(eid)

    def build(self, executor: str = "flat", **params) -> None:
        self.db.build_ann(executor, **params)

    # context management = DSM on the same hierarchy
    def reorganize(self, op: str, src: str, dst: str) -> None:
        if op == "move":
            self.db.move(src, dst)
        elif op == "merge":
            self.db.merge(src, dst)
        else:
            raise ValueError(op)

    def retrieve_batch(self, query_vecs: np.ndarray, scopes: Sequence[str],
                       cfg: RAGConfig, recursive=True,
                       exclude: Optional[Sequence[Sequence[str]]] = None
                       ) -> List[Tuple[List[ContextEntry], Dict[str, float]]]:
        """Batched scoped retrieval: N concurrent requests resolve repeated
        scopes once and share ranking launches (``dsq_batch``). With
        ``cfg.executor == "sharded"`` the shared scan runs on the row
        shards (bitwise the flat result; the shard and merge bytes are
        surfaced in the stats). With
        ``cfg.precision`` "int8" or "pq" the ranking runs the two-phase
        quantized plan (the byte split and rescored candidate counts are
        surfaced in the stats)."""
        results = self.db.dsq_batch(np.atleast_2d(query_vecs), list(scopes),
                                    k=cfg.k, recursive=recursive,
                                    exclude=exclude, executor=cfg.executor,
                                    precision=cfg.precision,
                                    rescore_k=cfg.rescore_k)
        return [self._format_result(res) for res in results]

    def _format_result(self, res) -> Tuple[List[ContextEntry],
                                           Dict[str, float]]:
        """(payload hits, stats dict) for one DSQResult — shared by the
        direct ``retrieve_batch`` path and the scheduled async path, so a
        scheduled request surfaces the same stats plus the scheduler's own
        terms."""
        hits = [self.payloads[int(i)] for i in res.ids[0] if int(i) >= 0]
        stats = {"directory_us": res.directory_ns / 1e3,
                 "ann_us": res.ann_ns / 1e3, "scope_size": res.scope_size,
                 "plan": res.plan, "scope_shared": res.scope_shared}
        if res.batch is not None and res.batch.plan_source:
            # which decision layer planned this batch, and (for calibrated
            # models) the predicted-vs-actual ANN cost
            stats["plan_source"] = res.batch.plan_source
            if res.batch.predicted_ann_ns:
                stats["predicted_ann_us"] = res.batch.predicted_ann_ns / 1e3
        if res.batch is not None and res.batch.n_shards:
            stats["n_shards"] = res.batch.n_shards
            stats["shard_mask_bytes"] = res.batch.shard_mask_bytes
            stats["collective_bytes"] = res.batch.collective_bytes
        if res.batch is not None and res.batch.db_bytes_int8:
            stats["db_bytes_fp32"] = res.batch.db_bytes_fp32
            stats["db_bytes_int8"] = res.batch.db_bytes_int8
            stats["rescore_candidates"] = res.batch.rescore_candidates
        if res.batch is not None and res.batch.db_bytes_pq:
            stats["db_bytes_fp32"] = res.batch.db_bytes_fp32
            stats["db_bytes_pq"] = res.batch.db_bytes_pq
            stats["rescore_candidates"] = res.batch.rescore_candidates
        if res.batch is not None and res.batch.tiered:
            # tiered placement: where the fp32 rows live and what the
            # exact rescore actually pulled host->device this batch
            stats["rescore_fetch_bytes"] = res.batch.rescore_fetch_bytes
            stats["rows_device_pinned"] = res.batch.rows_device_pinned
            stats["rows_host"] = res.batch.rows_host
        if res.batch is not None and res.batch.sched_batches:
            # continuous-batching terms stamped by the scheduler: where this
            # request's batch sat in the serving pipeline, and how full it was
            b = res.batch
            stats["sched_queue_ms"] = (b.sched_queue_ns
                                       / max(b.batch_size, 1)) / 1e6
            stats["sched_stage_ms"] = b.sched_stage_ns / 1e6
            stats["sched_service_ms"] = b.sched_service_ns / 1e6
            stats["sched_occupancy"] = b.sched_occupancy / b.sched_batches
        return hits, stats

    def retrieve(self, query_vec: np.ndarray, scope: str, cfg: RAGConfig,
                 recursive: bool = True, exclude: Sequence[str] = ()
                 ) -> Tuple[List[ContextEntry], Dict[str, float]]:
        exc = [list(exclude)] if exclude else None
        return self.retrieve_batch(query_vec[None, :], [scope], cfg,
                                   recursive=recursive, exclude=exc)[0]

    def assemble(self, hits: List[ContextEntry], cfg: RAGConfig
                 ) -> np.ndarray:
        """Token-budgeted context: escalate only the top hits to full bodies
        (tiered loading); returns a 1-D token array."""
        parts: List[np.ndarray] = []
        used = 0
        for rank, h in enumerate(hits):
            toks = h.text_tokens
            if h.tier == "L2" and rank >= cfg.escalate_top:
                toks = toks[: max(8, len(toks) // 4)]    # abstract-level slice
            take = min(len(toks), cfg.token_budget - used)
            if take <= 0:
                break
            parts.append(toks[:take])
            used += take
        if not parts:
            return np.zeros(1, dtype=np.int32)
        return np.concatenate(parts).astype(np.int32)

    # ------------------------------------------------- async serving surface
    def start_serving(self, cfg: RAGConfig,
                      sched: Optional[SchedulerConfig] = None
                      ) -> "ScheduledDSQ":
        """Start the continuous-batching retrieval front end: concurrent
        :meth:`submit_retrieve` calls coalesce into scheduler-filled
        ``dsq_batch`` launches under the SLO flush policy, with weighted-fair
        admission and double-buffered mask/query staging. Results are
        bit-identical to :meth:`retrieve_batch` over the same batch."""
        if self._serving is not None:
            raise RuntimeError("serving already started")
        self._serving = ScheduledDSQ(
            self.db, k=cfg.k, executor=cfg.executor, precision=cfg.precision,
            rescore_k=cfg.rescore_k, cfg=sched).start()
        return self._serving

    def submit_retrieve(self, query_vec: np.ndarray, scope: str,
                        recursive: bool = True, exclude: Sequence[str] = (),
                        tenant: str = "default",
                        t_arrival: Optional[float] = None,
                        deadline_ms: Optional[float] = None
                        ) -> "RetrievalTicket":
        """Async submit: admit one retrieval into the scheduler (raises
        :class:`~repro_torch.serving.scheduler.AdmissionError` at queue
        capacity, :class:`~repro_torch.serving.scheduler.SchedulerUnhealthy`
        when a dead worker flipped the scheduler readonly). ``.result()``
        awaits the scheduler-filled batch and returns the same
        ``(hits, stats)`` pair :meth:`retrieve` would; a request still
        queued past ``deadline_ms`` instead raises a typed
        ``DeadlineExceeded``."""
        if self._serving is None:
            raise RuntimeError("call start_serving(cfg) first")
        ticket = self._serving.submit(query_vec, scope, recursive=recursive,
                                      exclude=exclude, tenant=tenant,
                                      t_arrival=t_arrival,
                                      deadline_ms=deadline_ms)
        return RetrievalTicket(ticket, self._format_result)

    def stop_serving(self) -> None:
        if self._serving is not None:
            self._serving.stop()
            self._serving = None

    def serving_stats(self, reset: bool = False) -> Dict[str, object]:
        """Window snapshot of the serving metrics: QPS, p50/p95/p99 latency,
        batch occupancy, shed rate, health state + degrade counters, merged
        batch accounting. ``reset=True`` starts the next window."""
        if self._serving is None:
            raise RuntimeError("serving not started")
        out = self._serving.metrics.snapshot(reset=reset)
        out["degrade_level"] = self._serving.degrade_level
        return out


class RetrievalTicket:
    """Await handle whose ``result()`` maps the scheduled DSQResult to the
    ``(hits, stats)`` pair of the synchronous retrieve path."""

    def __init__(self, ticket: ServingTicket, fmt):
        self._ticket = ticket
        self._fmt = fmt

    def done(self) -> bool:
        return self._ticket.done()

    def cancel(self) -> bool:
        """Abandon the retrieval (e.g. after ``result(timeout)`` timed
        out): its admission-queue slot is reclaimed at the next batch
        formation instead of leaking."""
        return self._ticket.cancel()

    def result(self, timeout: Optional[float] = None):
        return self._fmt(self._ticket.result(timeout))

    @property
    def latency_s(self) -> float:
        return self._ticket.latency_s

    @property
    def batch_size(self) -> int:
        return self._ticket.batch_size


class RAGServer:
    """Batched scoped retrieval + greedy decode. ``lm_params`` is the port's
    :class:`~repro_torch.models.Transformer`; the LM runs on its device."""

    def __init__(self, ctx_db: ContextDatabase, lm_params, lm_cfg,
                 cfg: RAGConfig):
        self.ctx = ctx_db
        self.params = lm_params
        self.lm_cfg = lm_cfg
        self.cfg = cfg
        self._sched: Optional[ContinuousScheduler] = None
        self._serving_new_tokens = 16
        # side stream of the staged query copies (made at the first stage
        # of a CUDA database)
        self._stream: Optional["torch.cuda.Stream"] = None

    def answer(self, query_vecs: np.ndarray, scopes: Sequence[str],
               prompts: Sequence[np.ndarray], max_new_tokens: int = 16,
               recursive: bool = True) -> Dict[str, object]:
        B = len(scopes)
        if len(prompts) not in (0, 1, B):
            raise ValueError(f"{len(prompts)} prompts for {B} requests "
                             "(want 0, 1 to broadcast, or one per request)")
        t0 = time.perf_counter()
        # one batched multi-scope DSQ for the whole request batch: repeated
        # scopes resolve once, scan-plan requests share a single launch
        retrieved = self.ctx.retrieve_batch(query_vecs, scopes, self.cfg,
                                            recursive=recursive)
        contexts, retrieval_stats = [], []
        for i, (hits, stats) in enumerate(retrieved):
            prompt = self._prompt_for(prompts, i)
            contexts.append(self.assemble_with_prompt(hits, prompt))
            retrieval_stats.append(stats)
        t1 = time.perf_counter()
        tokens = self._decode_batch(contexts, max_new_tokens)
        t2 = time.perf_counter()
        return {
            "tokens": tokens,
            "retrieval_stats": retrieval_stats,
            "retrieve_s": t1 - t0,
            "decode_s": t2 - t1,
        }

    def _decode_batch(self, contexts: List[np.ndarray],
                      max_new_tokens: int) -> np.ndarray:
        """Greedy decode over one coalesced context batch. As in the
        reference, contexts are right-padded with token 0 to the longest and
        the pad counts as content: prefill sets every row's length to the
        padded width, so a shorter context's first token is the argmax at a
        pad position. Greedy selection is the first index of the fp32
        logits' maximum, as ``jnp.argmax``."""
        max_len = max(len(c) for c in contexts)
        B = len(contexts)
        toks = np.zeros((B, max_len), dtype=np.int32)
        for i, c in enumerate(contexts):
            toks[i, : len(c)] = c
        cache_seq = max_len + self.lm_cfg.meta_tokens + max_new_tokens
        logits, cache = prefill(self.params, {"tokens": toks}, self.lm_cfg,
                                cache_seq)
        out_tokens = []
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for _ in range(max_new_tokens):
            out_tokens.append(cur[:, 0])
            logits, cache = decode_step(self.params, cache, cur, self.lm_cfg)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return torch.stack(out_tokens, dim=1).to(torch.int32).cpu().numpy()

    @staticmethod
    def _prompt_for(prompts: Sequence[np.ndarray], i: int) -> np.ndarray:
        """Request i's prompt: per-request when one prompt per request was
        given, broadcast when a single prompt was given, empty otherwise."""
        if len(prompts) == 0:
            return np.zeros(0, np.int32)
        if len(prompts) == 1:
            return np.asarray(prompts[0], np.int32)
        return np.asarray(prompts[i], np.int32)

    def assemble_with_prompt(self, hits, prompt: np.ndarray) -> np.ndarray:
        ctx = self.ctx.assemble(hits, self.cfg)
        return np.concatenate([ctx, np.asarray(prompt, np.int32)])

    # ------------------------------------------------- async serving surface
    def start(self, sched: Optional[SchedulerConfig] = None,
              max_new_tokens: int = 16) -> "RAGServer":
        """Start the continuous-batching answer front end: concurrent
        :meth:`submit` calls coalesce into scheduler-filled batches that run
        the full retrieve -> assemble -> prefill -> decode pipeline. The
        retrieval staging (scope masks + query upload) double-buffers
        against the previous batch's ranking and decode."""
        if self._sched is not None:
            raise RuntimeError("server already started")
        self._serving_new_tokens = max_new_tokens
        self._sched = ContinuousScheduler(
            self._serve_batch, stage=self._stage_batch, cfg=sched).start()
        return self

    def submit(self, query_vec: np.ndarray, scope: str,
               prompt: Sequence[int] = (), recursive: bool = True,
               tenant: str = "default",
               t_arrival: Optional[float] = None) -> ServingTicket:
        """Admit one answer request (typed :class:`AdmissionError` at queue
        capacity). ``.result()`` returns ``{"tokens", "hits",
        "retrieval_stats"}`` for this request, produced by a
        scheduler-filled batch."""
        if self._sched is None:
            raise RuntimeError("call start() first")
        payload = (np.asarray(query_vec, np.float32), scope, bool(recursive),
                   (), np.asarray(prompt, np.int32))
        return self._sched.submit(payload, tenant=tenant, t_arrival=t_arrival)

    def stop(self) -> None:
        if self._sched is not None:
            self._sched.stop()
            self._sched = None

    def serving_stats(self, reset: bool = False) -> Dict[str, object]:
        if self._sched is None:
            raise RuntimeError("server not started")
        return self._sched.metrics.snapshot(reset=reset)

    def _stage_batch(self, payloads) -> object:
        db = self.ctx.db
        if self._stream is None and db.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=db.device)
        return stage_dsq(db, payloads, self.cfg.k, "fs", self.cfg.executor,
                         stream=self._stream)

    def _serve_batch(self, payloads, staged) -> List[Dict[str, object]]:
        """Execute one scheduler-coalesced answer batch: same pipeline as
        :meth:`answer`, returning one result dict per request."""
        queries, scopes, rec, _ = assemble_dsq(payloads)
        prompts = [p[4] for p in payloads]
        try:
            retrieved = self.ctx.retrieve_batch(queries, scopes, self.cfg,
                                                recursive=rec)
        finally:
            # retrieval ranks the host matrix; the staged device copy is
            # never read, and its pinned buffer goes once the copy is done
            if isinstance(staged, StagedQueries):
                staged.release()
        contexts = [self.assemble_with_prompt(hits, prompt)
                    for (hits, _), prompt in zip(retrieved, prompts)]
        tokens = self._decode_batch(contexts, self._serving_new_tokens)
        return [{"tokens": tokens[i], "hits": retrieved[i][0],
                 "retrieval_stats": retrieved[i][1]}
                for i in range(len(payloads))]
