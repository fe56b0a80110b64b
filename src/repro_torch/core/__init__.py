"""Core: batch HC-s-t simple path query processing (the paper's
contribution), on PyTorch tensors."""
from .graph import Graph, DeviceGraph
from .query import (PathQuery, QueryResult, BatchReport, Planner, Output,
                    QueryLike, ResultStatus)
from .engine import BatchPathEngine, EngineConfig, EngineOverflow
from .session import PathSession
from .index import build_index, QueryIndex
from . import generators, oracle

__all__ = ["Graph", "DeviceGraph", "BatchPathEngine", "EngineConfig",
           "EngineOverflow", "PathQuery", "QueryResult", "BatchReport",
           "Planner", "Output", "QueryLike", "ResultStatus", "PathSession",
           "build_index", "QueryIndex", "generators", "oracle"]
