"""State carried across from the reference: build a port database from the
plain arrays and path strings a reference database holds.

The state of a directory-scoped vector database is its store rows, its
tombstones, per namespace its directories and the directory each live entry
sits in, once the PQ tier has been used its frozen PQ codebook, and once an
IVF index is built its centers and member lists. Those are plain numpy
arrays and strings, so the port takes them as they are and never a
``repro`` object.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .database import DirectoryVectorDB
from .ivf import IVFIndex


def from_state(vectors: np.ndarray,
               namespace_paths: Dict[str, Sequence[Optional[str]]],
               deleted: Optional[np.ndarray] = None, *,
               namespace_dirs: Optional[Dict[str, Sequence[str]]] = None,
               pq_centroids: Optional[np.ndarray] = None,
               pq_encoded: int = 0,
               metric: str = "ip", scope_strategy: str = "triehi",
               device=None, calibration=None) -> DirectoryVectorDB:
    """A flat-executor port database holding the given state.

    ``vectors`` (n, d) are the store rows exactly as stored (already
    unit-normalised for ``cos``); ``namespace_paths`` maps a namespace name
    to one directory path per row, ``None`` for a row the namespace does not
    hold (a deleted entry); ``deleted`` (n,) bool marks tombstoned rows.
    ``namespace_dirs`` maps a namespace to every directory it has, so
    directories that hold no entry exist in the port too. ``pq_centroids``
    (M, 256, dsub) is a trained PQ codebook to serve ``precision="pq"``
    with instead of training one (the source trains once, on the rows
    present at its first PQ use, and keeps it frozen); ``pq_encoded`` is
    the source's encode watermark, the rows encoded at conversion."""
    vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
    db = DirectoryVectorDB(vectors.shape[1], metric=metric,
                           scope_strategy=scope_strategy,
                           calibration=calibration, device=device)
    for name, dirs in (namespace_dirs or {}).items():
        idx = db.namespace(name)
        for path in dirs:
            idx.mkdir(path)
    ids = db.store.append_rows(vectors)
    db._bind(ids, dict(namespace_paths))
    if deleted is not None:
        db.store.mark_deleted(np.flatnonzero(np.asarray(deleted, bool)))
    if pq_centroids is not None:
        db.store.set_pq_codebook(pq_centroids, pq_encoded)
    db.build_ann("flat")
    return db


def ivf_from_state(db: DirectoryVectorDB, centers: np.ndarray,
                   lists: Sequence[np.ndarray],
                   repartition_gen: int = 0) -> IVFIndex:
    """Attach an IVF index with the given ``centers`` (n_lists, d) and member
    ``lists`` (one id array per list, in list order) to ``db`` as its
    ``"ivf"`` executor, without training: torch and XLA round k-means
    differently, so a port index trained on the same rows would not probe
    the same partitions as the source's."""
    ivf = IVFIndex.from_lists(db.store, centers, lists, repartition_gen)
    db.executors["ivf"] = ivf
    return ivf
