"""Datalog-based graph-extraction DSL (paper §3.2).

Grammar (non-recursive Datalog subset + comparison predicates)::

    query    := rule+
    rule     := head ":-" body "."
    head     := ("Nodes" | "Edges") "(" var ("," var)* ")"
    body     := atom ("," atom)*
    atom     := RelName "(" arg ("," arg)* ")" | comparison
    arg      := var | "_" | INT | 'string'
    comparison := var OP (INT | FLOAT | 'string'),  OP in < > <= >= = !=

Examples (paper Figures 1 & 4)::

    Nodes(ID, Name)  :- Author(ID, Name).
    Edges(ID1, ID2)  :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).

    Nodes(ID, Name)  :- Customer(ID, Name).
    Edges(ID1, ID2)  :- Orders(ok1, ID1), LineItem(ok1, pk),
                        Orders(ok2, ID2), LineItem(ok2, pk).

Atom arguments map positionally to table columns.  Constants in atom
arguments or comparison predicates become selections.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple, Union

__all__ = [
    "Atom",
    "Comparison",
    "Rule",
    "ExtractionQuery",
    "parse",
    "ParseError",
]


class ParseError(ValueError):
    pass


Constant = Union[int, float, str]


@dataclasses.dataclass(frozen=True)
class Atom:
    relation: str
    args: Tuple[str, ...]          # variable names; "_" = wildcard
    constants: Tuple[Tuple[int, Constant], ...] = ()  # (position, value)

    def variables(self) -> Tuple[str, ...]:
        return tuple(a for a in self.args if a != "_")


@dataclasses.dataclass(frozen=True)
class Comparison:
    var: str
    op: str
    value: Constant

    _OPS = {
        "<": lambda a, b: a < b,
        ">": lambda a, b: a > b,
        "<=": lambda a, b: a <= b,
        ">=": lambda a, b: a >= b,
        "=": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
    }

    def apply(self, col):
        import numpy as np

        return self._OPS[self.op](col, self.value)


@dataclasses.dataclass(frozen=True)
class Rule:
    kind: str                      # "nodes" | "edges"
    head_vars: Tuple[str, ...]
    atoms: Tuple[Atom, ...]
    comparisons: Tuple[Comparison, ...] = ()


@dataclasses.dataclass(frozen=True)
class ExtractionQuery:
    nodes_rules: Tuple[Rule, ...]
    edges_rules: Tuple[Rule, ...]

    @property
    def heterogeneous(self) -> bool:
        return len(self.nodes_rules) > 1


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*|%[^\n]*)
  | (?P<implies>:-)
  | (?P<op><=|>=|!=|<|>|=)
  | (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<comma>,)
  | (?P<dot>\.)
  | (?P<string>'[^']*'|"[^"]*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"unexpected character {text[pos]!r} at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.tokens[self.i]

    def next(self, kind: Optional[str] = None) -> Tuple[str, str]:
        tok = self.tokens[self.i]
        if kind is not None and tok[0] != kind:
            raise ParseError(f"expected {kind}, got {tok[1]!r}")
        self.i += 1
        return tok

    # rule := head :- body .
    def parse_rule(self) -> Rule:
        _, name = self.next("ident")
        if name not in ("Nodes", "Edges"):
            raise ParseError(f"rule head must be Nodes or Edges, got {name!r}")
        head_vars = self._arglist_vars()
        self.next("implies")
        atoms: List[Atom] = []
        comparisons: List[Comparison] = []
        while True:
            atoms_or_cmp = self._body_item()
            if isinstance(atoms_or_cmp, Atom):
                atoms.append(atoms_or_cmp)
            else:
                comparisons.append(atoms_or_cmp)
            if self.peek()[0] == "comma":
                self.next("comma")
                continue
            break
        self.next("dot")
        kind = name.lower()
        if kind == "nodes" and len(head_vars) < 1:
            raise ParseError("Nodes needs at least an ID attribute")
        if kind == "edges" and len(head_vars) < 2:
            raise ParseError("Edges needs at least (ID1, ID2)")
        if not atoms:
            raise ParseError("rule body needs at least one relational atom")
        return Rule(kind, tuple(head_vars), tuple(atoms), tuple(comparisons))

    def _arglist_vars(self) -> List[str]:
        self.next("lparen")
        out: List[str] = []
        while True:
            _, v = self.next("ident")
            out.append(v)
            if self.peek()[0] == "comma":
                self.next("comma")
                continue
            break
        self.next("rparen")
        return out

    def _body_item(self) -> Union[Atom, Comparison]:
        kind, val = self.next()
        if kind != "ident":
            raise ParseError(f"expected atom or comparison, got {val!r}")
        if self.peek()[0] == "op":  # comparison: var OP const
            _, op = self.next("op")
            ckind, cval = self.next()
            if ckind == "number":
                value: Constant = float(cval) if "." in cval else int(cval)
            elif ckind == "string":
                value = cval[1:-1]
            else:
                raise ParseError(f"comparison value must be constant, got {cval!r}")
            return Comparison(val, op, value)
        # relational atom
        self.next("lparen")
        args: List[str] = []
        constants: List[Tuple[int, Constant]] = []
        pos = 0
        while True:
            akind, aval = self.next()
            if akind == "ident":
                args.append(aval)
            elif akind == "number":
                args.append("_")
                constants.append((pos, float(aval) if "." in aval else int(aval)))
            elif akind == "string":
                args.append("_")
                constants.append((pos, aval[1:-1]))
            else:
                raise ParseError(f"bad atom argument {aval!r}")
            pos += 1
            if self.peek()[0] == "comma":
                self.next("comma")
                continue
            break
        self.next("rparen")
        return Atom(val, tuple(args), tuple(constants))


def parse(text: str) -> ExtractionQuery:
    """Parse a DSL program into an :class:`ExtractionQuery`."""
    parser = _Parser(_tokenize(text))
    nodes: List[Rule] = []
    edges: List[Rule] = []
    while parser.peek()[0] != "eof":
        rule = parser.parse_rule()
        (nodes if rule.kind == "nodes" else edges).append(rule)
    if not nodes:
        raise ParseError("query needs at least one Nodes statement")
    if not edges:
        raise ParseError("query needs at least one Edges statement")
    return ExtractionQuery(tuple(nodes), tuple(edges))
