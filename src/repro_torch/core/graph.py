"""Edge-labeled directed graphs for CFPQ.

Includes an RDF-triple loader matching the paper's evaluation protocol (each
triple ``(o, p, s)`` becomes edges ``(o, p, s)`` and ``(s, p_r, o)``) and
deterministic generators that reproduce ontology-like graphs of the sizes in
the paper's Tables 1-2 (the container is offline, so the datasets from [30]
are regenerated rather than downloaded).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

INVERSE_SUFFIX = "_r"


@dataclass(frozen=True)
class EdgeDelta:
    """Net effect of a graph's edge log over a version range.

    ``inserted`` are edges present now that were absent at the start of the
    range; ``deleted`` the reverse.  Edges inserted then deleted inside the
    range (or vice versa) cancel out.
    """

    inserted: tuple[tuple[int, str, int], ...]
    deleted: tuple[tuple[int, str, int], ...]

    def __bool__(self) -> bool:
        return bool(self.inserted or self.deleted)

    @property
    def inserted_sources(self) -> set[int]:
        return {i for i, _, _ in self.inserted}

    @property
    def deleted_sources(self) -> set[int]:
        return {i for i, _, _ in self.deleted}


@dataclass
class Graph:
    """An edge-labeled digraph with nodes ``0..n_nodes-1``.

    Mutation goes through :meth:`insert_edges` / :meth:`delete_edges`: each
    call appends to an append-only edge log and bumps a monotone ``version``
    counter, so consumers holding materialized state (the query engine's
    closure cache) can ask :meth:`delta_since` for the net edit set instead
    of re-fingerprinting the whole edge list.  Direct edits of ``edges``
    remain possible but are invisible to the log (the engine falls back to
    full invalidation for those).
    """

    n_nodes: int
    edges: list[tuple[int, str, int]] = field(default_factory=list)
    version: int = 0
    _log: list[tuple[int, str, tuple[int, str, int]]] = field(
        default_factory=list, repr=False
    )
    _edge_set: set | None = field(default=None, repr=False, compare=False)
    _edge_set_len: int = field(default=-1, repr=False, compare=False)
    _log_floor: int = field(default=0, repr=False, compare=False)

    def __post_init__(self) -> None:
        # Collapse duplicate (i, x, j) entries, keeping first-occurrence
        # order.  Everything downstream treats ``edges`` as a set —
        # ``n_edges`` feeds the planner's density feature, ``insert_edges``
        # assumes no duplicates — so a duplicated input edge must not
        # survive construction.
        if len(set(self.edges)) != len(self.edges):
            seen: set[tuple[int, str, int]] = set()
            uniq = [e for e in self.edges if not (e in seen or seen.add(e))]
            self.edges = uniq

    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return len(self.edges)

    # ------------------------------------------------------------------ #
    # Mutation layer (delta subsystem; see DELTA.md).
    # ------------------------------------------------------------------ #
    def edge_set(self) -> set:
        """Membership set of ``edges``, kept in sync by the mutation API so
        a stream of small deltas pays O(delta) per insert call, not O(E).
        Rebuilt if the edge list was edited out-of-band (detected by the
        length heuristic; a same-length in-place swap escapes it, but the
        query engine catches those by comparing edge sets per batch)."""
        if self._edge_set is None or self._edge_set_len != len(self.edges):
            self._edge_set = set(self.edges)
            self._edge_set_len = len(self.edges)
        return self._edge_set

    def _validate_edge(self, edge: tuple[int, str, int]) -> None:
        i, _, j = edge
        if not (0 <= i < self.n_nodes and 0 <= j < self.n_nodes):
            raise ValueError(f"edge {edge} outside graph of {self.n_nodes}")

    def insert_edges(self, edges: list[tuple[int, str, int]]) -> int:
        """Insert edges; already-present edges are no-ops.  Returns the new
        version (bumped once per call that changed anything)."""
        have = self.edge_set()
        added = []
        for e in edges:
            e = (int(e[0]), e[1], int(e[2]))
            self._validate_edge(e)
            if e not in have:
                have.add(e)
                added.append(e)
        if added:
            self.version += 1
            self.edges.extend(added)
            self._edge_set_len = len(self.edges)
            self._log.extend((self.version, "+", e) for e in added)
        return self.version

    def delete_edges(self, edges: list[tuple[int, str, int]]) -> int:
        """Delete edges (all duplicate occurrences); absent edges are
        no-ops.  Returns the new version.  (Deletion compacts the edge
        list — O(E); insertion is O(delta).)"""
        gone = set()
        for e in edges:
            e = (int(e[0]), e[1], int(e[2]))
            self._validate_edge(e)
            gone.add(e)
        removed = sorted(gone & self.edge_set())
        if removed:
            self.version += 1
            drop = set(removed)
            self.edges[:] = [e for e in self.edges if e not in drop]
            self._edge_set -= drop
            self._edge_set_len = len(self.edges)
            self._log.extend((self.version, "-", e) for e in removed)
        return self.version

    def compact_log(self, min_version: int) -> int:
        """Snapshot + truncate the edge log (the log is otherwise append-only
        and unbounded).  The current ``edges`` list IS the snapshot — log
        entries only exist to serve :meth:`delta_since` — so once every
        consumer has ingested past ``min_version``, entries at versions
        ``<= min_version`` can be dropped.  ``delta_since`` then errors
        cleanly for versions before the compaction floor (consumers that
        fell behind must resynchronize from the snapshot, e.g. the query
        engine's full-invalidation path).  Returns the number of log
        entries dropped."""
        if min_version > self.version:
            raise ValueError(
                f"cannot compact to {min_version}: graph is at "
                f"{self.version}"
            )
        start = bisect.bisect_right(
            self._log, min_version, key=lambda r: r[0]
        )
        del self._log[:start]
        self._log_floor = max(self._log_floor, min_version)
        return start

    def delta_since(self, version: int) -> EdgeDelta:
        """Net edge delta between ``version`` and the current version.
        O(tail): the log is version-sorted, so the start is bisected.
        Raises ValueError for versions ahead of the graph or behind the
        compaction floor (see :meth:`compact_log`)."""
        if version > self.version:
            raise ValueError(
                f"version {version} is ahead of the graph ({self.version})"
            )
        if version < self._log_floor:
            raise ValueError(
                f"version {version} predates the compacted log "
                f"(floor {self._log_floor})"
            )
        start = bisect.bisect_right(self._log, version, key=lambda r: r[0])
        ins: set[tuple[int, str, int]] = set()
        dels: set[tuple[int, str, int]] = set()
        for _, op, edge in self._log[start:]:
            if op == "+":
                if edge in dels:
                    dels.discard(edge)  # delete then re-insert: net no-op
                else:
                    ins.add(edge)
            else:
                if edge in ins:
                    ins.discard(edge)  # insert then delete: net no-op
                else:
                    dels.add(edge)
        return EdgeDelta(tuple(sorted(ins)), tuple(sorted(dels)))

    @property
    def labels(self) -> list[str]:
        seen: list[str] = []
        for _, x, _ in self.edges:
            if x not in seen:
                seen.append(x)
        return seen

    def edges_by_label(self) -> dict[str, np.ndarray]:
        """label -> int32 array (m, 2) of (src, dst)."""
        by: dict[str, list[tuple[int, int]]] = {}
        for i, x, j in self.edges:
            by.setdefault(x, []).append((i, j))
        return {
            x: np.asarray(sorted(set(p)), dtype=np.int32).reshape(-1, 2)
            for x, p in by.items()
        }

    # ------------------------------------------------------------------ #
    @classmethod
    def from_triples(
        cls, triples: list[tuple[str, str, str]], add_inverse: bool = True
    ) -> "Graph":
        """Paper protocol: (o, p, s) -> edge (o,p,s) and (s, p_r, o).
        Repeated triples collapse to one edge (``__post_init__``)."""
        ids: dict[str, int] = {}

        def nid(name: str) -> int:
            if name not in ids:
                ids[name] = len(ids)
            return ids[name]

        edges = []
        for o, p, s in triples:
            oi, si = nid(o), nid(s)
            edges.append((oi, p, si))
            if add_inverse:
                edges.append((si, p + INVERSE_SUFFIX, oi))
        return cls(len(ids), edges)

    @classmethod
    def from_rdf_file(cls, path: str, add_inverse: bool = True) -> "Graph":
        """Tiny N-Triples-ish loader: whitespace-separated ``o p s .`` lines."""
        triples = []
        with open(path) as fh:
            for raw in fh:
                line = raw.strip().rstrip(".").strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 3:
                    continue
                o, p, s = parts[0], parts[1], parts[2]
                triples.append((o, _localname(p), s))
        return cls.from_triples(triples, add_inverse=add_inverse)

    # ------------------------------------------------------------------ #
    def repeat(self, times: int) -> "Graph":
        """The paper's synthetic ``g1..g3``: disjoint copies of a base graph."""
        edges = []
        for t in range(times):
            off = t * self.n_nodes
            edges.extend((i + off, x, j + off) for i, x, j in self.edges)
        return Graph(self.n_nodes * times, edges)


def _localname(uri: str) -> str:
    uri = uri.strip("<>")
    for sep in ("#", "/"):
        if sep in uri:
            uri = uri.rsplit(sep, 1)[1]
    return uri


# ---------------------------------------------------------------------- #
# Deterministic generators (paper-scale stand-ins for the RDF dataset).
# ---------------------------------------------------------------------- #


def paper_example_graph() -> Graph:
    """The 3-node graph of the paper's worked example (Section 4.3, Fig. 5)."""
    return Graph(
        3,
        [
            (0, "subClassOf_r", 0),
            (0, "type_r", 1),
            (1, "type_r", 2),
            (2, "subClassOf", 0),
            (2, "type", 2),
        ],
    )


def ontology_graph(
    n_classes: int,
    n_instances: int,
    seed: int = 0,
    branching: int = 3,
) -> Graph:
    """An ontology-like graph: a ``subClassOf`` forest over classes plus
    ``type`` edges from instances to classes, with inverse edges — the same
    label vocabulary as the paper's same-generation queries."""
    rng = np.random.default_rng(seed)
    triples: list[tuple[str, str, str]] = []
    for c in range(1, n_classes):
        parent = int(rng.integers(max(0, (c - 1) // branching), c))
        triples.append((f"c{c}", "subClassOf", f"c{parent}"))
    for i in range(n_instances):
        c = int(rng.integers(0, n_classes))
        triples.append((f"i{i}", "type", f"c{c}"))
    return Graph.from_triples(triples)


def worst_case_graph(k: int) -> Graph:
    """Two cycles of coprime-ish lengths sharing a node — the classic CFPQ
    worst case for grammar ``S -> a S b | a b`` (result size Theta(n^2))."""
    edges = []
    for i in range(k):
        edges.append((i, "a", (i + 1) % k))
    m = k + 1
    nodes = [0] + list(range(k, k + m - 1))
    for t in range(m):
        edges.append((nodes[t], "b", nodes[(t + 1) % m]))
    return Graph(k + m - 1, edges)


def random_labeled_graph(
    n_nodes: int, n_edges: int, labels: list[str], seed: int = 0
) -> Graph:
    """``n_edges`` *distinct* uniform edges (clamped to the number possible).

    Draws are rejection-sampled against a seen-set so the same seed always
    yields the same graph; without the dedupe, colliding draws used to
    survive into ``Graph.edges`` and inflate ``n_edges`` (and every
    density-derived planner/bench feature) past the true edge count.
    """
    rng = np.random.default_rng(seed)
    target = min(n_edges, n_nodes * n_nodes * len(labels))
    seen: set[tuple[int, str, int]] = set()
    edges: list[tuple[int, str, int]] = []
    while len(edges) < target:
        i = int(rng.integers(0, n_nodes))
        j = int(rng.integers(0, n_nodes))
        x = labels[int(rng.integers(0, len(labels)))]
        e = (i, x, j)
        if e not in seen:
            seen.add(e)
            edges.append(e)
    return Graph(n_nodes, edges)


#: Name -> (n_classes, n_instances, seed) chosen so the generated triple
#: counts land near the paper's Table 1 ontology sizes.
PAPER_TABLE_GRAPHS = {
    "skos": (30, 96, 1),
    "generations": (38, 99, 2),
    "travel": (40, 99, 3),
    "univ-bench": (44, 103, 4),
    "atom-primitive": (140, 73, 5),
    "biomedical-measure-primitive": (150, 80, 6),
    "foaf": (90, 226, 7),
    "people-pets": (110, 211, 8),
    "funding": (180, 364, 9),
    "wine": (290, 630, 10),
    "pizza": (330, 661, 11),
}


def paper_table_graph(name: str) -> Graph:
    if name in PAPER_TABLE_GRAPHS:
        n_c, n_i, seed = PAPER_TABLE_GRAPHS[name]
        return ontology_graph(n_c, n_i, seed=seed)
    if name in ("g1", "g2", "g3"):
        # the paper repeats existing graphs; 4x keeps the pure-python
        # worklist baseline tractable on this 1-core container while still
        # exercising the size-growth regime (the paper used ~8x)
        base = {"g1": "funding", "g2": "wine", "g3": "pizza"}[name]
        return paper_table_graph(base).repeat(4)
    raise KeyError(name)
