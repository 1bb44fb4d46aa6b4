"""Synthetic relational catalogs (paper §6, App. C).

* :func:`dblp_catalog`  — Author / Pub / AuthorPub (co-author graphs)
* :func:`tpch_catalog`  — Customer / Orders / LineItem ("customers who
  bought the same item", the multi-layer Fig 5a example)
* :func:`univ_catalog`  — Instructor / Student / TaughtCourse / TookCourse
  (heterogeneous bipartite [Q3])
* :func:`barabasi_albert_condensed` / :func:`layered_condensed` — condensed
  graphs straight from the App. C.1 / C.2 generators

All draw from ``numpy.random.default_rng(seed)`` in the same order as the
JAX package's generators, so one seed gives identical tables and graphs in
both.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.condensed import BipartiteEdges, Chain, CondensedGraph
from ..core.relational import Catalog, Table

__all__ = [
    "dblp_catalog",
    "tpch_catalog",
    "univ_catalog",
    "zipf_sizes",
    "barabasi_albert_condensed",
    "layered_condensed",
]


def zipf_sizes(n: int, mean: float, rng: np.random.Generator, a: float = 2.5) -> np.ndarray:
    """Heavy-tailed sizes with a given mean (paper datasets are skewed)."""
    raw = rng.zipf(a, size=n).astype(np.float64)
    raw *= mean / raw.mean()
    return np.maximum(raw.astype(np.int64), 1)


def dblp_catalog(
    n_authors: int = 2000,
    n_pubs: int = 3000,
    mean_authors_per_pub: float = 3.0,
    seed: int = 0,
) -> Catalog:
    """Authors, publications and the AuthorPub membership table.

    One weighted draw without replacement per publication, so the host
    cost grows as ``n_pubs * n_authors``."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(zipf_sizes(n_pubs, mean_authors_per_pub, rng), n_authors)
    pub_ids = np.repeat(np.arange(n_pubs), sizes)
    # Preferential-ish author assignment: zipf-weighted sampling.
    w = 1.0 / np.arange(1, n_authors + 1) ** 0.8
    w /= w.sum()
    author_ids = np.concatenate(
        [rng.choice(n_authors, size=s, replace=False, p=w) for s in sizes]
    )
    years = rng.integers(1990, 2024, size=n_pubs)
    authors = Table(
        "Author",
        {
            "aid": np.arange(n_authors),
            "name": np.array([f"author_{i}" for i in range(n_authors)]),
        },
    )
    pubs = Table(
        "Pub",
        {"pid": np.arange(n_pubs) + 1_000_000, "year": years},
    )
    author_pub = Table(
        "AuthorPub",
        {"aid": author_ids, "pid": pub_ids + 1_000_000},
    )
    return Catalog([authors, pubs, author_pub])


def tpch_catalog(
    n_customers: int = 1000,
    n_orders: int = 4000,
    n_parts: int = 300,
    mean_items_per_order: float = 3.0,
    seed: int = 0,
) -> Catalog:
    rng = np.random.default_rng(seed)
    cust_of_order = rng.integers(0, n_customers, size=n_orders)
    sizes = zipf_sizes(n_orders, mean_items_per_order, rng)
    order_ids = np.repeat(np.arange(n_orders), sizes)
    part_w = 1.0 / np.arange(1, n_parts + 1) ** 1.1
    part_w /= part_w.sum()
    part_ids = rng.choice(n_parts, size=order_ids.size, p=part_w)
    customers = Table(
        "Customer",
        {
            "ckey": np.arange(n_customers),
            "name": np.array([f"cust_{i}" for i in range(n_customers)]),
        },
    )
    orders = Table(
        "Orders",
        {"okey": np.arange(n_orders) + 5_000_000, "ckey": cust_of_order},
    )
    lineitem = Table(
        "LineItem",
        {"okey": order_ids + 5_000_000, "pkey": part_ids + 9_000_000},
    )
    return Catalog([customers, orders, lineitem])


# ---------------------------------------------------------------------------
# Condensed-graph generators (paper App. C.1/C.2)
# ---------------------------------------------------------------------------

def univ_catalog(
    n_instructors: int = 50,
    n_students: int = 500,
    n_courses: int = 80,
    mean_courses_per_student: float = 4.0,
    seed: int = 0,
) -> Catalog:
    """Instructor / Student / TaughtCourse / TookCourse, a heterogeneous
    bipartite catalog (paper [Q3]); the JAX package's tables for one
    seed."""
    rng = np.random.default_rng(seed)
    taught_by = rng.integers(0, n_instructors, size=n_courses)
    sizes = zipf_sizes(n_students, mean_courses_per_student, rng)
    student_ids = np.repeat(np.arange(n_students), sizes)
    course_ids = rng.integers(0, n_courses, size=student_ids.size)
    instructors = Table(
        "Instructor",
        {
            "iid": np.arange(n_instructors) + 10_000_000,
            "name": np.array([f"instr_{i}" for i in range(n_instructors)]),
        },
    )
    students = Table(
        "Student",
        {
            "sid": np.arange(n_students) + 20_000_000,
            "name": np.array([f"stud_{i}" for i in range(n_students)]),
        },
    )
    taught = Table(
        "TaughtCourse",
        {"iid": taught_by + 10_000_000, "cid": np.arange(n_courses)},
    )
    took = Table(
        "TookCourse",
        {"sid": student_ids + 20_000_000, "cid": course_ids},
    )
    return Catalog([instructors, students, taught, took])


def barabasi_albert_condensed(
    n_real: int,
    n_virtual: int,
    mean_size: float,
    sd_size: float,
    seed: int = 0,
    p_initial: float = 0.15,
    p_random_after_split: float = 0.35,
) -> CondensedGraph:
    """App. C.1 generator: preferential-attachment condensed graphs.

    1. draw virtual node sizes ~ N(mean, sd);
    2. split each virtual node with probability relative to its size;
    3. attach an initial batch (``p_initial``) at random;
    4. remaining virtual nodes attach either at random (split children,
       with prob. ``p_random_after_split``) or preferentially: pick an
       anchor real node of sufficient degree and sample its neighborhood
       with probability proportional to (degree)^2;
    5. merge split children back together.
    """
    rng = np.random.default_rng(seed)
    sizes = np.maximum(
        rng.normal(mean_size, sd_size, size=n_virtual).astype(np.int64), 2
    )
    sizes = np.minimum(sizes, max(2, n_real - 1))

    # Step 2: split
    split_prob = np.clip(sizes / (sizes.max() + 1.0), 0.05, 0.9)
    is_split = rng.random(n_virtual) < split_prob
    members: List[np.ndarray] = [np.empty(0, np.int64)] * n_virtual
    degree = np.zeros(n_real, dtype=np.int64)

    def attach_random(size: int) -> np.ndarray:
        sel = rng.choice(n_real, size=size, replace=False)
        degree[sel] += 1
        return sel

    def attach_preferential(size: int) -> np.ndarray:
        anchors = np.flatnonzero(degree >= 1)
        if anchors.size == 0:
            return attach_random(size)
        r = int(anchors[rng.integers(anchors.size)])
        # Neighborhood = union of members of virtual nodes containing r —
        # approximated by degree-weighted sampling over attached nodes
        # (paper's P_i ∝ d(s_i)^2 rule).
        attached = np.flatnonzero(degree > 0)
        w = degree[attached].astype(np.float64) ** 2
        w /= w.sum()
        take = min(size, attached.size)
        sel = rng.choice(attached, size=take, replace=False, p=w)
        if take < size:
            rest = rng.choice(
                np.setdiff1d(np.arange(n_real), sel, assume_unique=False),
                size=size - take,
                replace=False,
            )
            sel = np.concatenate([sel, rest])
        degree[sel] += 1
        return sel

    order = rng.permutation(n_virtual)
    n_init = max(1, int(p_initial * n_virtual))
    for i, v in enumerate(order):
        size = int(sizes[v])
        if i < n_init:
            members[v] = attach_random(size)
        elif is_split[v] and rng.random() < p_random_after_split:
            members[v] = attach_random(size)
        else:
            members[v] = attach_preferential(size)

    src = np.concatenate(members)
    dst = np.concatenate(
        [np.full(m.size, v, dtype=np.int64) for v, m in enumerate(members)]
    )
    e_in = BipartiteEdges(src, dst, n_real, n_virtual)
    return CondensedGraph(n_real, [Chain([e_in, e_in.reversed()])])


def layered_condensed(
    n_real: int,
    layer_sizes: Sequence[int],
    edges_per_level: Sequence[int],
    seed: int = 0,
    symmetric: bool = True,
) -> CondensedGraph:
    """App. C.2 generator: k-layer chains with controlled selectivity.

    ``layer_sizes``  virtual nodes per layer (k entries);
    ``edges_per_level``  edge count per bipartite level (k+1 entries).
    Lower layer_size / edge ratio = lower selectivity = denser expansion.
    """
    rng = np.random.default_rng(seed)
    if len(edges_per_level) != len(layer_sizes) + 1:
        raise ValueError("need len(edges_per_level) == len(layer_sizes) + 1")
    levels = [n_real] + list(layer_sizes) + [n_real]
    edges: List[BipartiteEdges] = []
    for i, ne in enumerate(edges_per_level):
        n_src, n_dst = levels[i], levels[i + 1]
        src = rng.integers(0, n_src, size=ne)
        dst = rng.integers(0, n_dst, size=ne)
        # connectivity guarantee: each dst appears at least once
        probe = rng.permutation(n_dst)
        src2 = rng.integers(0, n_src, size=n_dst)
        edges.append(
            BipartiteEdges(
                np.concatenate([src, src2]),
                np.concatenate([dst, probe]),
                n_src,
                n_dst,
            )
        )
    if symmetric and len(layer_sizes) == 1:
        e_in = edges[0]
        return CondensedGraph(n_real, [Chain([e_in, e_in.reversed()])])
    return CondensedGraph(n_real, [Chain(edges)])
