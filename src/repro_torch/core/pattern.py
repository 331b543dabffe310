"""Kleene pattern AST and FSA-template derivation (paper Defs. 1, Sec. 3.1, Sec. 5).

A pattern is one of::

    E               (event type)
    P+              Kleene(P)
    SEQ(P1, .., Pn) Seq(...)
    NOT P           Not(P)         -- only as a component of a Seq
    P1 OR  P2       Or(...)        -- top level only; handled per Sec. 5
    P1 AND P2       And(...)       -- top level only; handled per Sec. 5

``analyze()`` turns a (negation-free, Or/And-free) pattern into the
finite-state-automaton view used throughout the paper: start/end types and the
predecessor-type edge set (Fig. 3, Fig. 8), plus negation constraints for
``Not`` components.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "Pattern", "EventType", "Kleene", "Seq", "Not", "Or", "And",
    "NegConstraint", "PatternInfo", "analyze",
]


class Pattern:
    """Base class; use the subclasses below."""

    def __add__(self, other: "Pattern") -> "Seq":  # convenience: A + B == SEQ(A, B)
        return Seq(self, other)


@dataclass(frozen=True)
class EventType(Pattern):
    name: str

    def __repr__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Kleene(Pattern):
    inner: Pattern

    def __repr__(self) -> str:
        return f"({self.inner!r})+"


@dataclass(frozen=True)
class Seq(Pattern):
    parts: tuple[Pattern, ...]

    def __init__(self, *parts: Pattern):
        object.__setattr__(self, "parts", tuple(parts))

    def __repr__(self) -> str:
        return "SEQ(" + ", ".join(repr(p) for p in self.parts) + ")"


@dataclass(frozen=True)
class Not(Pattern):
    inner: Pattern

    def __repr__(self) -> str:
        return f"NOT {self.inner!r}"


@dataclass(frozen=True)
class Or(Pattern):
    left: Pattern
    right: Pattern

    def __repr__(self) -> str:
        return f"({self.left!r} OR {self.right!r})"


@dataclass(frozen=True)
class And(Pattern):
    left: Pattern
    right: Pattern

    def __repr__(self) -> str:
        return f"({self.left!r} AND {self.right!r})"


@dataclass(frozen=True)
class NegConstraint:
    """NOT ``neg_type`` between ``before`` and ``after`` (paper Sec. 5).

    A matched negative event e_n disallows connections from matches of types
    ``before`` earlier than e_n to matches of types ``after`` later than e_n.
    ``before is None``  -> window start (leading NOT): trends may not *start*
    after e_n.  ``after is None`` -> window end (trailing NOT): trends may not
    *end* before e_n.
    """

    neg_type: str
    before: frozenset[str] | None
    after: frozenset[str] | None


@dataclass
class PatternInfo:
    """FSA-template view of a (positive part of a) pattern."""

    start: frozenset[str]
    end: frozenset[str]
    edges: frozenset[tuple[str, str]]  # (predecessor type, successor type)
    types: frozenset[str]              # positive types
    negatives: tuple[NegConstraint, ...] = field(default_factory=tuple)
    kleene_types: frozenset[str] = frozenset()  # E with a self-loop via Kleene E+

    def pred_types(self, e: str) -> frozenset[str]:
        """pt(E, q): predecessor types of E (paper Example 2)."""
        return frozenset(a for (a, b) in self.edges if b == e)


def _analyze_positive(p: Pattern) -> PatternInfo:
    if isinstance(p, EventType):
        return PatternInfo(
            start=frozenset({p.name}),
            end=frozenset({p.name}),
            edges=frozenset(),
            types=frozenset({p.name}),
        )
    if isinstance(p, Kleene):
        inner = _analyze_positive(p.inner)
        loop = frozenset((e, s) for e in inner.end for s in inner.start)
        kle = inner.kleene_types
        if isinstance(p.inner, EventType):
            kle = kle | {p.inner.name}
        return PatternInfo(
            start=inner.start,
            end=inner.end,
            edges=inner.edges | loop,
            types=inner.types,
            negatives=inner.negatives,
            kleene_types=kle,
        )
    if isinstance(p, Seq):
        if not p.parts:
            raise ValueError("empty SEQ")
        start: frozenset[str] | None = None
        frontier: frozenset[str] | None = None  # end types of the previous positive part
        edges: set[tuple[str, str]] = set()
        types: set[str] = set()
        negatives: list[NegConstraint] = []
        kleene: set[str] = set()
        pending_negs: list[str] = []  # NOT types awaiting the next positive part
        for part in p.parts:
            if isinstance(part, Not):
                if not isinstance(part.inner, EventType):
                    raise ValueError("NOT supports a single event type")
                pending_negs.append(part.inner.name)
                continue
            info = _analyze_positive(part)
            if info.types & types:
                raise ValueError(
                    f"event type(s) {sorted(info.types & types)} appear more than "
                    "once in one pattern; the type-keyed template requires each "
                    "type to appear once (paper Sec. 3.1)"
                )
            if start is None:
                start = info.start
                if pending_negs:  # leading NOT
                    for nt in pending_negs:
                        negatives.append(NegConstraint(nt, None, info.start))
                    pending_negs = []
            else:
                assert frontier is not None
                edges.update((a, b) for a in frontier for b in info.start)
                for nt in pending_negs:
                    negatives.append(NegConstraint(nt, frontier, info.start))
                pending_negs = []
            edges.update(info.edges)
            types.update(info.types)
            negatives.extend(info.negatives)
            kleene.update(info.kleene_types)
            frontier = info.end
        if start is None:
            raise ValueError("SEQ needs at least one positive part")
        assert frontier is not None
        for nt in pending_negs:  # trailing NOT
            negatives.append(NegConstraint(nt, frontier, None))
        return PatternInfo(
            start=start,
            end=frontier,
            edges=frozenset(edges),
            types=frozenset(types),
            negatives=tuple(negatives),
            kleene_types=frozenset(kleene),
        )
    if isinstance(p, (Or, And, Not)):
        raise ValueError(
            f"{type(p).__name__} is handled at the workload level (Sec. 5); "
            "call Query.expand() instead of analyze()"
        )
    raise TypeError(f"not a pattern: {p!r}")


def analyze(p: Pattern) -> PatternInfo:
    """FSA-template info for a pattern without top-level Or/And."""
    info = _analyze_positive(p)
    neg_types = {n.neg_type for n in info.negatives}
    if neg_types & info.types:
        raise ValueError("a type cannot be both positive and negative in one pattern")
    return info
