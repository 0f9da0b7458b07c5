"""Row-sharded directory-scoped search over a shard mesh — the port of
``repro/distributed/search.py``.

The store is split row-wise into ``n_shards`` blocks of ``n_loc`` rows,
shard ``s`` owning rows ``[s*n_loc, (s+1)*n_loc)`` on device ``mesh[s]``.
A search runs, per shard, the port's hand-written scan on that shard's rows
(kernel 1 for one dense mask, kernel 2 / 6 / 8 for packed scope words with
per-query scope ids) and keeps a local top-k; :func:`merge_local_topk` then
moves the (score, global id) pairs to the first shard's device (the
reference's all-gather: ``n_shards * k`` pairs a query) and takes one stable
top-k. The scan kernels score every (query, row) pair with one fixed-order
chain whatever the row block, and rank ties by the lower id, so the merged
result is bit for bit the single launch over all rows.

Each ``make_*`` function returns a callable over per-shard tensors
(lists indexed by shard); :func:`shard_rows` and :func:`shard_words` split
host arrays into that layout. The serving tier's entry points are
:func:`make_sharded_batch_search` and its ``_i8`` / ``_pq`` twins, consumed
by ``vectordb.sharded.ShardedExecutor``: one call ranks a heterogeneous
request batch against a resident packed scope table with the store's alive
words ANDed in. The reference's ``local_search`` closure of each builder
is the ``scan`` callback each builder hands :func:`_per_shard`.
:func:`search_input_specs` and :func:`multi_scope_search_input_specs`
describe the builders' arguments as meta tensors (no storage), for the
dry-run (``launch/dryrun.py``).

Sentinels: a lane with no candidate comes back as ``finfo(float32).min``
with id -1, as from the kernels; a local -1 keeps its -1 (adding the shard
offset to it would name a real row of the previous shard).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import ref as kref

NEG_INF = float(np.finfo(np.float32).min)
Tensors = Sequence[torch.Tensor]


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _local_rows(mesh, n_total: int) -> int:
    n_dev = len(mesh)
    if n_total % n_dev:
        raise ValueError(f"{n_total} rows do not split into {n_dev} shards")
    return n_total // n_dev


def _word_aligned(mesh, n_total: int) -> int:
    n_loc = _local_rows(mesh, n_total)
    if n_loc % 32:
        raise ValueError(f"{n_loc} local rows are not whole mask words")
    return n_loc


def _check_depth(k: int, n_loc: int) -> None:
    if not 0 < k <= n_loc:
        raise ValueError(f"per-shard top-{k} does not fit {n_loc} local rows")


def merge_local_topk(vals: Tensors, ids: Tensors, n_loc: int, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard-order merge of per-shard top-k lists: ``vals[s]`` (q, k_s)
    fp32 and ``ids[s]`` (q, k_s) local row ids (-1 = empty lane) of shard
    ``s``. Returns (vals (q, k) fp32, ids (q, k) int64 global ids) on the
    first shard's device, ranked by (score descending, global id
    ascending): the concatenation is shard-major and each shard's list is
    already in that order, so a stable sort resolves exact score ties to the
    lowest global id, as one top-k over all rows does. Empty lanes are
    ``finfo.min`` / -1."""
    dev = vals[0].device
    all_v, all_i = [], []
    for s, (v, i) in enumerate(zip(vals, ids)):
        i = i.to(dev).long()
        all_i.append(torch.where(i >= 0, i + s * n_loc,
                                 torch.full_like(i, -1)))
        all_v.append(torch.where(i >= 0, v.to(dev),
                                 torch.full_like(v.to(dev), NEG_INF)))
    cat_v = torch.cat(all_v, dim=1)
    cat_i = torch.cat(all_i, dim=1)
    top_v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
    top_v, pos = top_v[:, :k], pos[:, :k]
    top_i = cat_i.gather(1, pos)
    top_i = torch.where(top_v > NEG_INF, top_i, torch.full_like(top_i, -1))
    if top_v.shape[1] < k:                      # fewer pairs than k in all
        q, short = top_v.shape[0], k - top_v.shape[1]
        top_v = torch.cat([top_v, torch.full((q, short), NEG_INF,
                                             device=dev)], dim=1)
        top_i = torch.cat([top_i, torch.full((q, short), -1,
                                             dtype=torch.int64, device=dev)],
                          dim=1)
    return top_v, top_i


def shard_rows(mesh, host: np.ndarray, n_total: int) -> List[torch.Tensor]:
    """Split the first ``n_total`` rows of ``host`` (zero-padded past its
    end) into per-shard tensors on the mesh's devices."""
    n_loc = _local_rows(mesh, n_total)
    out = []
    for s, dev in enumerate(mesh):
        block = np.zeros((n_loc,) + host.shape[1:], dtype=host.dtype)
        part = host[s * n_loc:(s + 1) * n_loc]
        block[:len(part)] = part
        out.append(torch.from_numpy(block).to(dev))
    return out


def shard_words(mesh, words: np.ndarray, n_total: int) -> List[torch.Tensor]:
    """Split packed uint32 words (a row ``(W,)`` or a table ``(S, W)``
    covering ``n_total`` rows) on the word dimension: shard ``s`` gets the
    ``n_loc / 32`` words covering its rows, as int32 views."""
    n_loc = _word_aligned(mesh, n_total)
    w = np.ascontiguousarray(words, dtype=np.uint32)
    wl = n_loc // 32
    full = np.zeros(w.shape[:-1] + (n_total // 32,), dtype=np.uint32)
    full[..., :min(w.shape[-1], n_total // 32)] = w[..., :n_total // 32]
    return [torch.from_numpy(np.ascontiguousarray(
        full[..., s * wl:(s + 1) * wl]).view(np.int32)).to(dev)
        for s, dev in enumerate(mesh)]


def _slots_used(sids) -> Tuple[np.ndarray, np.ndarray]:
    """(distinct scope rows a batch reads, each request's index into them)."""
    sids = np.asarray(sids.cpu() if isinstance(sids, torch.Tensor) else sids,
                      dtype=np.int64)
    used, local = np.unique(sids, return_inverse=True)
    return used, local.astype(np.int32)


def _shard_words(table: torch.Tensor, alive: Optional[torch.Tensor],
                 used: np.ndarray) -> torch.Tensor:
    """The used rows of one shard's scope table, ANDed with its alive
    words."""
    rows = table.index_select(0, torch.from_numpy(used).to(table.device))
    return rows if alive is None else rows & alive[None, :]


def _per_shard(mesh, n_loc: int, k: int, scan: Callable
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, ids = [], []
    for s, dev in enumerate(mesh):
        v, i = scan(s, dev)
        vals.append(v)
        ids.append(i)
    return merge_local_topk(vals, ids, n_loc, k)


def _local_scores(db_l: torch.Tensor, queries: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """The reference's ``local_search`` scores (``search.py:67-76``) for
    bf16 or int8 rows: int8 rows upcast to bf16 times bf16(1/127), queries
    cast to bf16, and the bf16 products summed in fp32 (a bf16 x bf16
    product is exact in fp32, so the fp32 matmul of the widened operands
    is that contraction)."""
    if db_l.dtype == torch.int8:
        db_l = db_l.to(torch.bfloat16) * torch.tensor(
            1.0 / 127, dtype=torch.bfloat16, device=db_l.device)
    x = db_l.float()
    scores = queries.to(device=db_l.device, dtype=torch.bfloat16).float() @ x.T
    if metric == "l2":
        scores = 2 * scores - (x * x).sum(dim=-1)[None, :]
    return scores


def make_scoped_search(mesh, n_total: int, dim: int, k: int,
                       metric: str = "ip", dtype=None) -> Callable:
    """``search(db, mask, queries, sq=None)`` with ``db[s]`` (n_loc, dim)
    and ``mask[s]`` (n_loc,) int8 per shard and ``queries`` (q, dim).
    Returns (scores (q, k), global ids (q, k) int64).

    fp32 rows (``dtype`` None or ``torch.float32``): kernel 1 on each
    shard, then the merge; ``sq[s]`` are the shard's squared row norms (l2
    only; computed from its rows when omitted). ``torch.bfloat16`` or
    ``torch.int8`` rows: the reference's ``local_search`` on each shard
    (:func:`_local_scores`, no kernel: the reference computes it outside
    Pallas too), the scope mask, a tie-stable top-k, then the merge."""
    n_loc = _local_rows(mesh, n_total)
    _check_depth(k, n_loc)
    if dtype not in (None, torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"rows of {dtype}: fp32, bf16 or int8 only")
    low = dtype in (torch.bfloat16, torch.int8)

    def search(db: Tensors, mask: Tensors, queries: torch.Tensor,
               sq: Optional[Tensors] = None):
        def scan(s, dev):
            if low:
                scores = _local_scores(db[s], queries, metric)
                return kref.stable_topk(torch.where(
                    mask[s].to(dev)[None, :] != 0, scores,
                    torch.full_like(scores, NEG_INF)), k)
            return kops.scoped_topk(queries.to(dev), db[s], mask[s], k,
                                    metric, sq=None if sq is None else sq[s])
        return _per_shard(mesh, n_loc, k, scan)
    return search


def search_input_specs(mesh, n_total: int, dim: int, n_queries: int,
                       dtype=torch.bfloat16):
    """Meta tensors of :func:`make_scoped_search`'s arguments (no
    storage): per shard ``db`` (n_loc, dim) ``dtype`` and ``mask``
    (n_loc,) int8, and the (q, dim) bf16 queries."""
    n_loc = _local_rows(mesh, n_total)
    db = [_meta((n_loc, dim), dtype) for _ in mesh]
    mask = [_meta((n_loc,), torch.int8) for _ in mesh]
    return db, mask, _meta((n_queries, dim), torch.bfloat16)


def multi_scope_search_input_specs(mesh, n_total: int, dim: int,
                                   n_queries: int, n_scopes: int,
                                   dtype=torch.float32):
    """Meta tensors of :func:`make_sharded_batch_search`'s arguments: per
    shard ``db`` (n_loc, dim) ``dtype``, the scope table's ``words``
    (n_scopes, n_loc/32) and ``alive`` (n_loc/32,) words (int32 views of
    the packed uint32 words, as the kernels take them), then ``sids`` (q,)
    int32 and the (q, dim) fp32 queries. ``n_total`` must split into
    whole words per shard (a multiple of 32 x shards)."""
    n_loc = _word_aligned(mesh, n_total)
    db = [_meta((n_loc, dim), dtype) for _ in mesh]
    words = [_meta((n_scopes, n_loc // 32), torch.int32) for _ in mesh]
    alive = [_meta((n_loc // 32,), torch.int32) for _ in mesh]
    return (db, words, alive, _meta((n_queries,), torch.int32),
            _meta((n_queries, dim), torch.float32))


def make_multi_scope_search(mesh, n_total: int, dim: int, k: int,
                            metric: str = "ip") -> Callable:
    """``search(db, mask_words, scope_ids, queries, sq=None)``: the batched
    heterogeneous-scope variant of :func:`make_scoped_search`.
    ``mask_words[s]`` is shard ``s``'s (n_scopes, n_loc/32) int32 slice of
    the packed scope matrix (32x less mask traffic than dense int8) and
    ``scope_ids`` (q,) each request's row in it: kernel 2 on each shard,
    over the scope rows the batch uses, then the merge."""
    n_loc = _word_aligned(mesh, n_total)
    _check_depth(k, n_loc)

    def search(db: Tensors, mask_words: Tensors, scope_ids,
               queries: torch.Tensor, sq: Optional[Tensors] = None):
        used, local = _slots_used(scope_ids)

        def scan(s, dev):
            return kops.multi_scope_topk(
                queries.to(dev), db[s], _shard_words(mask_words[s], None,
                                                     used),
                torch.from_numpy(local).to(dev), k, metric,
                sq=None if sq is None else sq[s])
        return _per_shard(mesh, n_loc, k, scan)
    return search


def make_sharded_batch_search(mesh, n_total: int, dim: int, k: int,
                              metric: str = "ip") -> Callable:
    """The serving tier's fp32 launch: ``search(db, words, alive, sids,
    queries, sq=None)`` with, per shard, ``db[s]`` (n_loc, dim) fp32,
    ``words[s]`` its (slots, n_loc/32) int32 slice of the resident scope
    table and ``alive[s]`` its (n_loc/32,) alive ∧ in-range words
    (tombstoned and capacity-padding rows are 0); ``sids`` (q,) each
    request's table row. Per shard, the rows of the table the batch uses
    are ANDed with the alive words and kernel 2 ranks them; the merge
    returns (scores (q, k), global ids (q, k)). The per-shard scores are
    the flat executor's bits (one fixed-order chain per pair), so the
    result equals the flat batch for ip and cos. For l2 each shard's norms
    ``sq[s]`` are its own rows' (``row_sq_norms``) while the flat executor
    reads the store's: equal values, but outside the bitwise contract, as
    in the reference."""
    n_loc = _word_aligned(mesh, n_total)
    _check_depth(k, n_loc)

    def search(db: Tensors, words: Tensors, alive: Tensors, sids,
               queries: torch.Tensor, sq: Optional[Tensors] = None):
        used, local = _slots_used(sids)

        def scan(s, dev):
            return kops.multi_scope_topk(
                queries.to(dev), db[s], _shard_words(words[s], alive[s],
                                                     used),
                torch.from_numpy(local).to(dev), k, metric,
                sq=None if sq is None else sq[s])
        return _per_shard(mesh, n_loc, k, scan)
    return search


def make_sharded_batch_search_i8(mesh, n_total: int, dim: int, r: int,
                                 metric: str = "ip") -> Callable:
    """int8 scan phase of the two-phase sharded plan: ``search(qdb, qscale,
    words, alive, sids, q_i8, q_scale, sq=None)``, each shard scoring its
    slice of the int8 store with kernel 6 (a quarter of the fp32 bytes)
    and keeping its local top-``r``; the merge gives the global top-``r``
    candidates, which the caller rescores once in exact fp32. ``sq[s]`` are
    the shard's dequantized-row squared norms (read for l2 only, where the
    int8 kernel needs them). The scores are the quantized approximations:
    callers rescore, not rank, by them."""
    n_loc = _word_aligned(mesh, n_total)
    _check_depth(r, n_loc)

    def search(qdb: Tensors, qscale: Tensors, words: Tensors,
               alive: Tensors, sids, q_i8: torch.Tensor,
               q_scale: torch.Tensor, sq: Optional[Tensors] = None):
        used, local = _slots_used(sids)

        def scan(s, dev):
            return kops.multi_scope_topk_i8(
                q_i8.to(dev), q_scale.to(dev), qdb[s], qscale[s],
                None if sq is None else sq[s],
                _shard_words(words[s], alive[s], used),
                torch.from_numpy(local).to(dev), r, metric)
        return _per_shard(mesh, n_loc, r, scan)
    return search


def make_sharded_batch_search_pq(mesh, n_total: int, m: int,
                                 r: int) -> Callable:
    """PQ/ADC scan phase of the two-phase sharded plan: ``search(pqdb,
    words, alive, sids, lut)`` with ``pqdb[s]`` (n_loc, m) uint8 codes and
    ``lut`` (q, m, 256) fp32 tables with the metric folded in; kernel 8 on
    each shard keeps its local top-``r``, the merge the global top-``r``
    candidates for the caller's exact fp32 rescore."""
    n_loc = _word_aligned(mesh, n_total)
    _check_depth(r, n_loc)

    def search(pqdb: Tensors, words: Tensors, alive: Tensors, sids,
               lut: torch.Tensor):
        used, local = _slots_used(sids)

        def scan(s, dev):
            return kops.multi_scope_topk_pq(
                lut.to(dev), pqdb[s], _shard_words(words[s], alive[s], used),
                torch.from_numpy(local).to(dev), r)
        return _per_shard(mesh, n_loc, r, scan)
    return search


__all__ = ["merge_local_topk", "shard_rows", "shard_words",
           "make_scoped_search", "make_multi_scope_search",
           "make_sharded_batch_search", "make_sharded_batch_search_i8",
           "make_sharded_batch_search_pq", "search_input_specs",
           "multi_scope_search_input_specs"]
