from .convert import from_state, ivf_from_state
from .costmodel import (HEURISTIC, CalibrationArtifact, CostModel, model_of,
                        resolve_calibration)
from .database import DSQResult, DirectoryVectorDB
from .flat import FlatExecutor
from .graph import PGIndex
from .ivf import IVFIndex
from .maintenance import MaintenanceManager, MaintenancePolicy
from .planner import (BatchAccounting, BatchPlanner, PlanGroup, ScopeKey,
                      ScopeMaskCache, device_popcount)
from .sharded import ShardedExecutor
from .store import ShardedStoreView, VectorStore, pack_ids_to_words

__all__ = ["DirectoryVectorDB", "DSQResult", "FlatExecutor", "PGIndex",
           "IVFIndex", "VectorStore", "ShardedExecutor", "ShardedStoreView",
           "BatchAccounting", "BatchPlanner", "PlanGroup", "ScopeKey",
           "ScopeMaskCache", "device_popcount", "pack_ids_to_words",
           "CalibrationArtifact", "CostModel", "HEURISTIC", "model_of",
           "resolve_calibration", "from_state", "ivf_from_state",
           "MaintenanceManager", "MaintenancePolicy"]
