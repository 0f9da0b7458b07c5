"""State carried across from the reference: build a port database from the
plain arrays and path strings a reference database holds.

The state of a directory-scoped vector database is its store rows, its
tombstones and, per namespace, the directory each live entry sits in. Those
are plain numpy arrays and strings, so the port takes them as they are and
never a ``repro`` object.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .database import DirectoryVectorDB


def from_state(vectors: np.ndarray,
               namespace_paths: Dict[str, Sequence[Optional[str]]],
               deleted: Optional[np.ndarray] = None, *,
               metric: str = "ip", scope_strategy: str = "triehi",
               device=None, calibration=None) -> DirectoryVectorDB:
    """A flat-executor port database holding the given state.

    ``vectors`` (n, d) are the store rows exactly as stored (already
    unit-normalised for ``cos``); ``namespace_paths`` maps a namespace name
    to one directory path per row, ``None`` for a row the namespace does not
    hold (a deleted entry); ``deleted`` (n,) bool marks tombstoned rows.
    Directories that hold no entry are not part of the state: a scope on one
    resolves empty either way."""
    vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
    db = DirectoryVectorDB(vectors.shape[1], metric=metric,
                           scope_strategy=scope_strategy,
                           calibration=calibration, device=device)
    ids = db.store.append_rows(vectors)
    db._bind(ids, dict(namespace_paths))
    if deleted is not None:
        db.store.mark_deleted(np.flatnonzero(np.asarray(deleted, bool)))
    db.build_ann("flat")
    return db
