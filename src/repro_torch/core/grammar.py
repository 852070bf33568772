"""Context-free grammars and the Chomsky-normal-form transform.

The paper (Azimov & Grigorev) assumes grammars in CNF *without* a designated
start symbol (the start nonterminal is chosen per query) and without
``A -> eps`` rules (only empty paths ``m pi m`` match the empty string).

We let users write arbitrary CFGs in a small text format and normalize:

    S -> subClassOf_r S subClassOf | type_r S type
    S -> subClassOf_r subClassOf
    S -> type_r type

Symbols appearing on some left-hand side are nonterminals; everything else is
a terminal.  ``eps`` denotes the empty string.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Production:
    lhs: str
    rhs: tuple[str, ...]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{self.lhs} -> {' '.join(self.rhs) if self.rhs else 'eps'}"


@dataclass
class Grammar:
    """A general CFG (no normal-form restrictions)."""

    productions: list[Production]
    nonterminals: list[str] = field(default_factory=list)
    terminals: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        lhs = {p.lhs for p in self.productions}
        seen_n, seen_t = [], []
        for p in self.productions:
            for s in (p.lhs, *p.rhs):
                if s in lhs:
                    if s not in seen_n:
                        seen_n.append(s)
                elif s not in seen_t:
                    seen_t.append(s)
        self.nonterminals = seen_n
        self.terminals = seen_t

    # ------------------------------------------------------------------ #
    @classmethod
    def from_text(cls, text: str) -> "Grammar":
        prods: list[Production] = []
        for raw in text.strip().splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            lhs, _, rhs_all = line.partition("->")
            lhs = lhs.strip()
            if not lhs or not _:
                raise ValueError(f"bad production line: {raw!r}")
            for alt in rhs_all.split("|"):
                syms = tuple(s for s in alt.split() if s not in ("eps", "ε"))
                prods.append(Production(lhs, syms))
        return cls(prods)

    # ------------------------------------------------------------------ #
    def to_cnf(self) -> "CNFGrammar":
        """Standard CNF transform: TERM, BIN, DEL (eps), UNIT.

        Because the paper's grammars have no designated start symbol we do not
        preserve derivability of eps by a start rule; instead the set of
        nullable nonterminals is reported on the result (an empty path
        ``m pi m`` matches nonterminal A iff A is nullable).
        """
        prods = list(self.productions)
        fresh = itertools.count()
        lhs_set = {p.lhs for p in prods}

        def new_nt(hint: str) -> str:
            while True:
                cand = f"_{hint}{next(fresh)}"
                if cand not in lhs_set:
                    lhs_set.add(cand)
                    return cand

        # TERM: replace terminals inside rules of length >= 2.
        term_nt: dict[str, str] = {}
        out: list[Production] = []
        for p in prods:
            if len(p.rhs) >= 2:
                rhs = []
                for s in p.rhs:
                    if s not in lhs_set:  # terminal
                        if s not in term_nt:
                            term_nt[s] = new_nt("t")
                            out.append(Production(term_nt[s], (s,)))
                        rhs.append(term_nt[s])
                    else:
                        rhs.append(s)
                out.append(Production(p.lhs, tuple(rhs)))
            else:
                out.append(p)
        prods = out

        # BIN: binarize.
        out = []
        for p in prods:
            if len(p.rhs) <= 2:
                out.append(p)
                continue
            cur = p.lhs
            rest = list(p.rhs)
            while len(rest) > 2:
                nxt = new_nt("b")
                out.append(Production(cur, (rest[0], nxt)))
                cur, rest = nxt, rest[1:]
            out.append(Production(cur, tuple(rest)))
        prods = out

        # DEL: compute nullables and expand.
        nullable: set[str] = set()
        changed = True
        while changed:
            changed = False
            for p in prods:
                if p.lhs not in nullable and all(s in nullable for s in p.rhs):
                    nullable.add(p.lhs)
                    changed = True
        out = []
        seen = set()
        for p in prods:
            opts = [
                [s] if s not in nullable else [s, None] for s in p.rhs
            ]
            for combo in itertools.product(*opts):
                rhs = tuple(s for s in combo if s is not None)
                if not rhs:
                    continue  # eps rules dropped (nullable set reported)
                key = (p.lhs, rhs)
                if key not in seen:
                    seen.add(key)
                    out.append(Production(p.lhs, rhs))
        prods = out

        # UNIT: eliminate A -> B chains.
        unit_reach: dict[str, set[str]] = {n: {n} for n in lhs_set}
        changed = True
        while changed:
            changed = False
            for p in prods:
                if len(p.rhs) == 1 and p.rhs[0] in lhs_set:
                    for src, reach in unit_reach.items():
                        if p.lhs in reach and p.rhs[0] not in reach:
                            reach.add(p.rhs[0])
                            changed = True
        out, seen = [], set()
        for src, reach in unit_reach.items():
            for tgt in reach:
                for p in prods:
                    if p.lhs != tgt:
                        continue
                    if len(p.rhs) == 1 and p.rhs[0] in lhs_set:
                        continue  # unit rule itself
                    key = (src, p.rhs)
                    if key not in seen:
                        seen.add(key)
                        out.append(Production(src, p.rhs))
        return CNFGrammar.from_productions(out, nullable, self.nonterminals)


@dataclass
class CNFGrammar:
    """A grammar in CNF, indexed for the matrix algorithm.

    ``nonterms[i]`` is the name of nonterminal i.  ``term_prods`` maps each
    terminal label to the array of nonterminal indices A with ``A -> x``.
    ``binary_prods`` is the list of (A, B, C) index triples for ``A -> B C``,
    sorted by A.
    """

    nonterms: list[str]
    term_prods: dict[str, list[int]]
    binary_prods: list[tuple[int, int, int]]
    nullable: set[str] = field(default_factory=set)

    @classmethod
    def from_productions(
        cls,
        prods: list[Production],
        nullable: set[str] | None = None,
        prefer_order: list[str] | None = None,
    ) -> "CNFGrammar":
        names: list[str] = []
        for name in prefer_order or []:
            if any(p.lhs == name for p in prods) and name not in names:
                names.append(name)
        for p in prods:
            if p.lhs not in names:
                names.append(p.lhs)
        idx = {n: i for i, n in enumerate(names)}
        term_prods: dict[str, list[int]] = {}
        binary: list[tuple[int, int, int]] = []
        for p in prods:
            if len(p.rhs) == 1:
                term_prods.setdefault(p.rhs[0], []).append(idx[p.lhs])
            elif len(p.rhs) == 2:
                b, c = p.rhs
                if b not in idx or c not in idx:
                    raise ValueError(f"non-CNF binary production {p}")
                binary.append((idx[p.lhs], idx[b], idx[c]))
            else:
                raise ValueError(f"non-CNF production {p}")
        for x, lst in term_prods.items():
            term_prods[x] = sorted(set(lst))
        binary = sorted(set(binary))
        return cls(names, term_prods, binary, set(nullable or ()))

    @property
    def n_nonterms(self) -> int:
        return len(self.nonterms)

    def index_of(self, name: str) -> int:
        return self.nonterms.index(name)


# ---------------------------------------------------------------------- #
# The paper's example grammars.
# ---------------------------------------------------------------------- #

#: Same-generation query over an ontology graph (paper Fig. 3 / Query 1).
QUERY1_TEXT = """
S -> subClassOf_r S subClassOf | type_r S type
S -> subClassOf_r subClassOf | type_r type
"""

#: Adjacent-layer query (paper Fig. 11 / Query 2).
QUERY2_TEXT = """
S -> B subClassOf | subClassOf
B -> subClassOf_r B subClassOf | subClassOf_r subClassOf
"""

#: The paper's hand-normalized CNF for Query 1 (Fig. 4), used to replay the
#: worked example of Section 4.3 exactly (nonterminal names S, S1..S6).
PAPER_EXAMPLE_CNF = CNFGrammar.from_productions(
    [
        Production("S", ("S1", "S5")),
        Production("S", ("S3", "S6")),
        Production("S", ("S1", "S2")),
        Production("S", ("S3", "S4")),
        Production("S5", ("S", "S2")),
        Production("S6", ("S", "S4")),
        Production("S1", ("subClassOf_r",)),
        Production("S2", ("subClassOf",)),
        Production("S3", ("type_r",)),
        Production("S4", ("type",)),
    ],
    prefer_order=["S", "S1", "S2", "S3", "S4", "S5", "S6"],
)


def query1_grammar() -> Grammar:
    return Grammar.from_text(QUERY1_TEXT)


def query2_grammar() -> Grammar:
    return Grammar.from_text(QUERY2_TEXT)
