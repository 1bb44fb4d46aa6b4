"""Batched serving for the port: LM decode, graph-analytics micro-batching
and the continuous-batching multi-tenant graph tier."""
from .server import BatchedServer, GraphQuery, GraphQueryServer, Request, ServerStats
from .tier import (
    ExecutableCacheStats,
    GraphServingTier,
    ResultCacheStats,
    ServeRequest,
    ServeResult,
)

__all__ = [
    "BatchedServer",
    "GraphQuery",
    "GraphQueryServer",
    "Request",
    "ServerStats",
    "GraphServingTier",
    "ServeRequest",
    "ServeResult",
    "ExecutableCacheStats",
    "ResultCacheStats",
]
