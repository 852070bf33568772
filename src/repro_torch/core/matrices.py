"""The subsets-of-nonterminals matrix of the paper, as torch tensors.

A matrix ``a`` whose entries are subsets of N is stored as a stacked Boolean
tensor ``T`` of shape ``(|N|, n, n)`` — ``T[A, i, j]`` iff ``A in a[i, j]``
(the layout of ``repro.core.matrices``, so states cross between the two
packages unchanged; see :func:`from_reference` / :func:`to_reference`).

Physical layouts:
  * dense Boolean ``(N, n, n)`` — lifted to bf16 0/1 (fp32 on the CPU) for
    the matmul path;
  * bitpacked ``(N, n, ceil(n/32))`` **int32** — bit b of word w is column
    32w+b, the same bits as the reference's uint32 words.  torch's uint32
    has ``|`` but no shifts, ``amax``, ``index_put`` or add, so the port
    stores the words signed; ``.view(np.uint32)`` recovers the reference
    words exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .grammar import CNFGrammar
from .graph import Graph

LANE = 128  # kept from the TPU reference so padded shapes match it exactly


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA on a machine without a card
    raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclass(frozen=True)
class ProductionTables:
    """Index form of the CNF grammar.

    Stored as tuples so the whole object is hashable and can key the
    closure cache (the grammar is constant per plan; the graph is the data).
    """

    a_idx: tuple[int, ...]  # LHS nonterminal per production, sorted ascending
    b_idx: tuple[int, ...]
    c_idx: tuple[int, ...]
    n_nonterms: int

    @classmethod
    def from_grammar(cls, g: CNFGrammar) -> "ProductionTables":
        trip = sorted(g.binary_prods)
        return cls(
            tuple(t[0] for t in trip),
            tuple(t[1] for t in trip),
            tuple(t[2] for t in trip),
            g.n_nonterms,
        )

    @property
    def n_prods(self) -> int:
        return len(self.a_idx)

    def index_tensors(self, device: torch.device):
        """``(b_idx, c_idx)`` as int64 tensors on ``device`` (the gathers
        of every closure iteration)."""
        return (
            torch.tensor(self.b_idx, dtype=torch.int64, device=device),
            torch.tensor(self.c_idx, dtype=torch.int64, device=device),
        )


def padded_size(n: int, lane: int = LANE) -> int:
    return max(lane, -(-n // lane) * lane)


def init_matrix(
    graph: Graph,
    g: CNFGrammar,
    pad_to: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Lines 6-7 of Algorithm 1: T[A,i,j] = 1 iff (i,x,j) in E and A->x in P.

    Padding nodes have no edges and therefore never participate in any path,
    so padding is exact (not an approximation).
    """
    dev = resolve_device(device)
    n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
    if n < graph.n_nodes:
        raise ValueError("pad_to smaller than the graph")
    T = np.zeros((g.n_nonterms, n, n), dtype=bool)
    for i, x, j in graph.edges:
        for a in g.term_prods.get(x, ()):
            T[a, i, j] = True
    return torch.from_numpy(T).to(dev)


def init_matrix_rows(
    graph: Graph, g: CNFGrammar, rows, pad_to: int | None = None
) -> np.ndarray:
    """Base-matrix rows for a subset of source nodes: the ``rows`` slices
    of :func:`init_matrix`, shape ``(|N|, len(rows), n)`` — O(|rows|·n)
    memory instead of O(n²), for delta repair's row surgery."""
    n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
    pos = {int(r): k for k, r in enumerate(rows)}
    out = np.zeros((g.n_nonterms, len(pos), n), dtype=bool)
    for i, x, j in graph.edges:
        k = pos.get(i)
        if k is not None:
            for a in g.term_prods.get(x, ()):
                out[a, k, j] = True
    return out


# ---------------------------------------------------------------------- #
# Bitpacked layout: pack the trailing (column) axis, 32 columns per word.
# Both directions take all 32 bits of a block of rows at once and bound
# the block, so the temporaries stay small: a (…, w, 32) int32 expansion
# of the full-size state would be 32x the packed state.
# ---------------------------------------------------------------------- #


#: int32 words a pack or unpack expands at once (32 words per packed
#: word): 64 MB
PACK_BLOCK_WORDS = 1 << 24


def _row_blocks(rows: int, w: int) -> range:
    """Starts of the row blocks of a ``(rows, w)`` word view."""
    return range(0, rows, max(1, PACK_BLOCK_WORDS // (32 * max(w, 1))))


def pack_bits(T: torch.Tensor) -> torch.Tensor:
    """(…, n) bool -> (…, ceil(n/32)) int32, bit b of word w = column 32w+b.

    Bit 31 lands in the sign bit: ``1 << 31`` on int32 wraps to -2^31,
    which is exactly the reference's uint32 bit pattern."""
    n = T.shape[-1]
    w = -(-n // 32)
    pad = w * 32 - n
    if pad:
        T = torch.cat([T, T.new_zeros((*T.shape[:-1], pad))], dim=-1)
    out = torch.empty((*T.shape[:-1], w), dtype=torch.int32, device=T.device)
    # bits 0-30 of a word sum without overflow; bit 31 is ORed in as the
    # sign bit
    shifts = torch.arange(31, dtype=torch.int32, device=T.device)
    bits, words = T.reshape(-1, w, 32), out.view(-1, w)
    blocks = _row_blocks(bits.shape[0], w)
    for r in blocks:
        blk = bits[r:r + blocks.step].to(torch.int32)
        torch.bitwise_or((blk[..., :31] << shifts).sum(-1, dtype=torch.int32),
                         blk[..., 31] << 31, out=words[r:r + blocks.step])
    return out


def unpack_bits(Tp: torch.Tensor, n: int) -> torch.Tensor:
    """(…, w) int32 -> (…, n) bool."""
    w = Tp.shape[-1]
    out = torch.empty((*Tp.shape[:-1], w, 32), dtype=torch.bool, device=Tp.device)
    shifts = torch.arange(32, dtype=torch.int32, device=Tp.device)
    words, bits = Tp.reshape(-1, w), out.view(-1, w, 32)
    blocks = _row_blocks(words.shape[0], w)
    for r in blocks:
        torch.ne((words[r:r + blocks.step, :, None] >> shifts) & 1, 0,
                 out=bits[r:r + blocks.step])
    return out.reshape(*Tp.shape[:-1], w * 32)[..., :n]


def relations_from_matrix(
    T: torch.Tensor, g: CNFGrammar, n_nodes: int
) -> dict[str, set[tuple[int, int]]]:
    """Extract the context-free relations R_A (Theorem 2)."""
    T = T[:, :n_nodes, :n_nodes].cpu().numpy()
    out: dict[str, set[tuple[int, int]]] = {}
    for a, name in enumerate(g.nonterms):
        i, j = np.nonzero(T[a])
        out[name] = set(zip(i.tolist(), j.tolist()))
    return out


# ---------------------------------------------------------------------- #
# States carried across from the reference package (and back).
# ---------------------------------------------------------------------- #


def from_reference(
    array, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """A state of the reference package as the port's tensor.

    Boolean arrays (the ``(N, n, n)`` closure state, ``(n,)`` row masks)
    come across as bool; packed uint32 words come across as the int32
    words with the same bits.  Any array-like works (it is copied into a
    fresh numpy array first), so device arrays of the reference convert too.
    """
    a = np.array(array, copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.bool_:
        raise TypeError(f"expected a bool or uint32 state, got {a.dtype}")
    return torch.from_numpy(a).to(resolve_device(device))


def to_reference(t: torch.Tensor) -> np.ndarray:
    """The port's tensor as the reference's numpy form: bool stays bool,
    packed int32 words become uint32 words with the same bits."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    if a.dtype != np.bool_:
        raise TypeError(f"expected a bool or int32 state, got {a.dtype}")
    return a
