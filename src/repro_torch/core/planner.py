"""Extraction planning: chain ordering + large-output join detection (§3.3, §4.2).

For each Edges rule the planner:

1. orders the body atoms into a join chain from the atom binding ``ID1``
   to the atom binding ``ID2`` (acyclic conjunctive queries; Case 1 of the
   paper — Case 2 falls back to full expansion);
2. estimates every join's output with catalog ``n_distinct`` statistics and
   marks it *large-output* iff  ``|R||S|/d > 2(|R|+|S|)``  (paper Step 2);
3. splits the chain into segments at large-output joins — each segment is
   executed eagerly (hash joins; "handed to the database"), each postponed
   join attribute becomes a virtual-node layer.

``mode`` overrides: ``"condensed"`` postpones every join (paper Fig 5a),
``"expanded"`` postpones none (EXP extraction), ``"auto"`` uses the stats.

This is the part of the JAX package's planner that one-shot extraction
runs; the sharded segment executors and the extraction budget are not
ported yet (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dsl import Atom, Comparison, Rule
from .relational import Catalog, Table, hash_join

__all__ = [
    "ChainPlan",
    "plan_rule",
    "bind_atom",
    "execute_segment",
]


@dataclasses.dataclass
class ChainPlan:
    """One Edges rule's executable plan (paper §3.3/§4.2 Step 2): the
    chain-ordered atoms, the per-link large-output decisions, and the
    eager segments between postponed joins."""

    rule: Rule
    atoms: List[Atom]            # chain order
    link_vars: List[str]         # join variable between consecutive atoms
    large: List[bool]            # per link: postponed (virtual layer)?
    est_sizes: List[float]       # per link: estimated join output rows
    segments: List[Tuple[int, int]]  # inclusive atom index ranges
    endpoint_vars: Tuple[str, str]   # (ID1 var, ID2 var)

    def describe(self) -> str:
        parts = []
        for i, a in enumerate(self.atoms):
            parts.append(a.relation)
            if i < len(self.link_vars):
                tag = "**" if self.large[i] else ""
                parts.append(f"-[{self.link_vars[i]}{tag}]-")
        return " ".join(parts)


def _chain_order(rule: Rule) -> Tuple[List[Atom], List[str]]:
    """Order atoms into a chain ID1 ~> ID2 (backtracking Hamiltonian path)."""
    id1, id2 = rule.head_vars[0], rule.head_vars[1]
    atoms = list(rule.atoms)
    if len(atoms) == 1:
        a = atoms[0]
        if id1 in a.variables() and id2 in a.variables():
            return atoms, []
        raise ValueError(f"single atom must bind both {id1} and {id2}")

    starts = [i for i, a in enumerate(atoms) if id1 in a.variables()]
    if not starts:
        raise ValueError(f"no atom binds {id1}")

    def shared(a: Atom, b: Atom) -> List[str]:
        return [v for v in a.variables() if v in b.variables()]

    def backtrack(path: List[int], links: List[str]) -> Optional[Tuple[List[int], List[str]]]:
        if len(path) == len(atoms):
            if id2 in atoms[path[-1]].variables():
                return path, links
            return None
        last = atoms[path[-1]]
        for j in range(len(atoms)):
            if j in path:
                continue
            for v in shared(last, atoms[j]):
                res = backtrack(path + [j], links + [v])
                if res:
                    return res
        return None

    for s in starts:
        res = backtrack([s], [])
        if res:
            order, links = res
            return [atoms[i] for i in order], links
    raise ValueError(
        f"atoms of rule do not form a chain from {id1} to {id2} "
        "(cyclic or disconnected query — paper Case 2); "
        "use mode='expanded'"
    )


def bind_atom(catalog: Catalog, atom: Atom, comparisons: Sequence[Comparison]) -> Table:
    """Materialize an atom (paper §4.2 Step 1/3): positional column ->
    variable binding, constant/equality selections, and the rule's
    comparison predicates pushed down to the base relation scan."""
    table = catalog.table(atom.relation)
    cols = table.column_names
    if len(atom.args) != len(cols):
        raise ValueError(
            f"atom {atom.relation}/{len(atom.args)} does not match table "
            f"arity {len(cols)} ({cols})"
        )
    mask = np.ones(len(table), dtype=bool)
    for pos, value in atom.constants:
        mask &= table.column(cols[pos]) == value
    var_cols: Dict[str, np.ndarray] = {}
    for var, col in zip(atom.args, cols):
        if var == "_":
            continue
        if var in var_cols:
            mask &= table.column(col) == var_cols[var]  # R(x, x) equality
            continue
        var_cols[var] = table.column(col)
    for cmp_ in comparisons:
        if cmp_.var in var_cols:
            mask &= np.asarray(cmp_.apply(var_cols[cmp_.var]), dtype=bool)
    rows = np.nonzero(mask)[0]
    return Table(atom.relation, {v: c[rows] for v, c in var_cols.items()})


def plan_rule(catalog: Catalog, rule: Rule, mode: str = "auto") -> ChainPlan:
    """Plan one Edges rule (paper §3.3 chain ordering + §4.2 Step 2
    large-output marking): order the body atoms into an ID1 ~> ID2 chain,
    estimate each link's join output from catalog ``n_distinct`` stats,
    and split the chain into eager segments at postponed joins.  ``mode``:
    ``'auto'`` (stats decide, the paper's ``|R||S|/d > 2(|R|+|S|)`` rule),
    ``'condensed'`` (postpone every join, Fig 5a), ``'expanded'``
    (postpone none — EXP extraction)."""
    if rule.kind != "edges":
        raise ValueError("plan_rule plans Edges rules")
    atoms, links = _chain_order(rule)
    id1, id2 = rule.head_vars[0], rule.head_vars[1]

    large: List[bool] = []
    est: List[float] = []
    for i, v in enumerate(links):
        lt = bind_atom(catalog, atoms[i], rule.comparisons)
        rt = bind_atom(catalog, atoms[i + 1], rule.comparisons)
        d = max(lt.stats(v).n_distinct, rt.stats(v).n_distinct, 1)
        size = len(lt) * len(rt) / d
        est.append(size)
        if mode == "condensed":
            large.append(True)
        elif mode == "expanded":
            large.append(False)
        else:
            large.append(size > 2 * (len(lt) + len(rt)))

    segments: List[Tuple[int, int]] = []
    start = 0
    for i, is_large in enumerate(large):
        if is_large:
            segments.append((start, i))
            start = i + 1
    segments.append((start, len(atoms) - 1))
    return ChainPlan(
        rule=rule,
        atoms=atoms,
        link_vars=links,
        large=large,
        est_sizes=est,
        segments=segments,
        endpoint_vars=(id1, id2),
    )


def execute_segment(
    catalog: Catalog,
    plan: ChainPlan,
    seg: Tuple[int, int],
    in_var: str,
    out_var: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run one small-output segment eagerly; returns (in_values, out_values).

    This is the part the paper "hands to the database" (§4.2 Step 3): a
    sequence of small-output hash joins, projected down to the segment
    endpoints, materialized on one host.
    """
    i, j = seg
    acc = bind_atom(catalog, plan.atoms[i], plan.rule.comparisons)
    for k in range(i + 1, j + 1):
        nxt = bind_atom(catalog, plan.atoms[k], plan.rule.comparisons)
        acc = hash_join(acc, nxt, plan.link_vars[k - 1], plan.link_vars[k - 1])
    if in_var not in acc.column_names or out_var not in acc.column_names:
        raise ValueError(
            f"segment {seg} missing endpoint vars {in_var}/{out_var}; "
            f"has {acc.column_names}"
        )
    return acc.column(in_var), acc.column(out_var)
