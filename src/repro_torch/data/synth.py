"""Synthetic relational catalogs (paper §6, App. C).

* :func:`dblp_catalog`  — Author / Pub / AuthorPub (co-author graphs)
* :func:`tpch_catalog`  — Customer / Orders / LineItem ("customers who
  bought the same item", the multi-layer Fig 5a example)

Both draw from ``numpy.random.default_rng(seed)`` in the same order as the
JAX package's generators, so one seed gives identical tables in both.
"""
from __future__ import annotations

import numpy as np

from ..core.relational import Catalog, Table

__all__ = [
    "dblp_catalog",
    "tpch_catalog",
    "zipf_sizes",
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
