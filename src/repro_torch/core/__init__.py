"""Core: batch HC-s-t simple path query processing (the paper's
contribution), on PyTorch tensors."""
from .graph import Graph, DeviceGraph
from .cache import SharedPathCache
from .delta import (GraphDelta, AppliedDelta, apply_delta,
                    update_device_graph, host_set_dist)
from .query import (PathQuery, QueryResult, BatchReport, Planner, Output,
                    QueryLike, ResultStatus)
from .engine import BatchPathEngine, EngineConfig, EngineOverflow, BatchResult
from .planner import CostEstimate, CostRouter, Route, RouterConfig
from .session import PathSession
from .index import build_index, QueryIndex
from . import distributed, generators, oracle, planner

__all__ = ["Graph", "DeviceGraph", "BatchPathEngine", "EngineConfig",
           "EngineOverflow", "BatchResult", "SharedPathCache",
           "GraphDelta", "AppliedDelta", "apply_delta",
           "update_device_graph", "host_set_dist",
           "PathQuery", "QueryResult", "BatchReport", "Planner", "Output",
           "QueryLike", "ResultStatus", "PathSession",
           "CostEstimate", "CostRouter", "Route", "RouterConfig",
           "build_index", "QueryIndex", "distributed", "generators",
           "oracle", "planner"]
