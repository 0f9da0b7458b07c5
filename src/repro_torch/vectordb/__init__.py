from .convert import from_state
from .costmodel import (HEURISTIC, CalibrationArtifact, CostModel, model_of,
                        resolve_calibration)
from .database import DSQResult, DirectoryVectorDB
from .flat import FlatExecutor
from .planner import (BatchAccounting, BatchPlanner, PlanGroup, ScopeKey,
                      ScopeMaskCache, device_popcount)
from .store import VectorStore, pack_ids_to_words

__all__ = ["DirectoryVectorDB", "DSQResult", "FlatExecutor", "VectorStore",
           "BatchAccounting", "BatchPlanner", "PlanGroup", "ScopeKey",
           "ScopeMaskCache", "device_popcount", "pack_ids_to_words",
           "CalibrationArtifact", "CostModel", "HEURISTIC", "model_of",
           "resolve_calibration", "from_state"]
