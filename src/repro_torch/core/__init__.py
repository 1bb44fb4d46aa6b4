"""The port's core: extraction (NumPy host side), the dedup family
(DEDUP-C, DEDUP-1/2, BITMAP-1/2, the wedge correction), the device engine
and the algorithm library.  Names are the JAX package's, so each
counterpart is found under the name it has in ``repro.core``.

    from repro_torch.core import extract, parse, CondensedGraph
    from repro_torch.core import engine, algorithms, dedup
    from repro_torch.core import propagate, propagate_wedge, triangle_counts
"""
from .algorithms import (
    Condensation,
    VertexProgram,
    clustering_coefficients,
    condensation,
    hits,
    scc_labels,
    shortest_paths,
    shortest_paths_multi,
    triangle_counts,
    vertex_program,
    widest_paths,
    widest_paths_multi,
)
from .condensed import (
    CSR,
    BipartiteEdges,
    Chain,
    CondensedGraph,
    ExpandedGraph,
    build_csr,
    collapse_to_single_layer,
    graphs_identical,
)
from .dedup import (
    BitmapRep,
    Dedup1Result,
    Dedup2Rep,
    bitmap1,
    bitmap2,
    build_correction,
    build_wedge_correction,
    dedup1_greedy_real_first,
    dedup1_greedy_virtual_first,
    dedup1_naive_real_first,
    dedup1_naive_virtual_first,
    dedup2_greedy,
    graph_from_membership,
    is_symmetric_single_layer,
    membership_sets,
)
from .dsl import ExtractionQuery, ParseError, parse
from .engine import propagate, propagate_wedge
from .extract import (
    ExtractionResult,
    extract,
    extract_query,
    extract_sharded,
    merge_spilled_graph,
)
from .planner import ExtractionBudget, ExtractionBudgetError
from .relational import Catalog, ShardedTable, Table
from .serialize import (
    ShardAssembly,
    ShardSpillStore,
    SpillError,
    export_edge_list,
    load_condensed,
    save_condensed,
)

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
    "CSR",
    "build_csr",
    "collapse_to_single_layer",
    # sharded, budgeted and spilled extraction (DESIGN.md §7-§8)
    "extract_sharded",
    "merge_spilled_graph",
    "ExtractionBudget",
    "ExtractionBudgetError",
    "ShardedTable",
    "save_condensed",
    "load_condensed",
    "export_edge_list",
    "ShardAssembly",
    "ShardSpillStore",
    "SpillError",
    # engine: propagate(..., layer_weights=) and the two-hop wedge path
    "propagate",
    "propagate_wedge",
    # dedup family (paper §5, App. B)
    "build_correction",
    "build_wedge_correction",
    "BitmapRep",
    "bitmap1",
    "bitmap2",
    "Dedup1Result",
    "dedup1_naive_virtual_first",
    "dedup1_naive_real_first",
    "dedup1_greedy_real_first",
    "dedup1_greedy_virtual_first",
    "Dedup2Rep",
    "dedup2_greedy",
    "membership_sets",
    "graph_from_membership",
    "is_symmetric_single_layer",
    # algorithm library
    "hits",
    "VertexProgram",
    "vertex_program",
    "shortest_paths",
    "shortest_paths_multi",
    "widest_paths",
    "widest_paths_multi",
    "scc_labels",
    "Condensation",
    "condensation",
    "triangle_counts",
    "clustering_coefficients",
]
