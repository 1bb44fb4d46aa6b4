"""The port's core: extraction (NumPy host side), DEDUP-C, the device
engine and the algorithm library.

    from repro_torch.core import extract, parse, CondensedGraph
    from repro_torch.core import engine, algorithms, dedup
"""
from .condensed import (
    BipartiteEdges,
    Chain,
    CondensedGraph,
    ExpandedGraph,
    graphs_identical,
)
from .dsl import ExtractionQuery, ParseError, parse
from .extract import ExtractionResult, extract, extract_query
from .relational import Catalog, Table

__all__ = [
    "BipartiteEdges",
    "Chain",
    "CondensedGraph",
    "ExpandedGraph",
    "ExtractionQuery",
    "ExtractionResult",
    "ParseError",
    "Catalog",
    "Table",
    "parse",
    "extract",
    "extract_query",
    "graphs_identical",
]
