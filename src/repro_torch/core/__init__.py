"""repro_torch.core — directory-semantic layer (the paper's contribution).

Exports the three scope-resolution strategies (§III–IV), the DSQ/DSM operator
layer, and the compressed entry-ID set used to hand candidates to the ANN
executor.
"""
from . import paths
from .catalog import Catalog, PathRef
from .idset import RoaringBitmap
from .interface import DSMDelta, DSMStats, ResolveStats, ScopeIndex
from .ops import (DSM, DSMBatchResult, DSMExecutor, DSMJournal, DSQ,
                  MAINT_PREFIX, RegionLockManager, regions_overlap)
from .pe_offline import PEOfflineIndex
from .pe_online import PEOnlineIndex
from .triehi import TrieHIIndex, TrieNode

STRATEGIES = {
    "pe_online": PEOnlineIndex,
    "pe_offline": PEOfflineIndex,
    "triehi": TrieHIIndex,
}


def make_scope_index(name: str) -> ScopeIndex:
    try:
        return STRATEGIES[name]()
    except KeyError:
        raise ValueError(f"unknown scope index {name!r}; "
                         f"choose from {sorted(STRATEGIES)}") from None


__all__ = [
    "paths", "Catalog", "PathRef", "RoaringBitmap", "ResolveStats",
    "ScopeIndex", "DSQ", "DSM", "DSMBatchResult", "DSMDelta", "DSMExecutor",
    "DSMJournal", "DSMStats", "MAINT_PREFIX", "RegionLockManager",
    "regions_overlap",
    "PEOnlineIndex", "PEOfflineIndex", "TrieHIIndex", "TrieNode",
    "STRATEGIES", "make_scope_index",
]
