"""Compressed-row-storage adjacency (paper §3.1: "it is preferred to store A
as a sparse matrix in CRS format as all the operations on A are row-wise").

Counterpart of ``repro/graph/csr.py``.  The matrix itself lives on the host
as numpy arrays (the generators and the neighbour sampler are numpy);
``matmat`` moves the arrays to the device of its dense operand and runs the
row-wise product there.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    data: np.ndarray       # (nnz,) float32
    indices: np.ndarray    # (nnz,) int32 column ids
    indptr: np.ndarray     # (n_rows + 1,) int32
    shape: Tuple[int, int]

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "CSRMatrix":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(shape[0] + 1, np.int32)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr, dtype=np.int32)
        return cls(vals, cols, indptr, tuple(shape))

    @classmethod
    def from_edges(cls, src, dst, n_nodes: int, symmetric: bool = True) -> "CSRMatrix":
        """Unweighted adjacency from an edge list; optionally symmetrised
        (the paper converts directed graphs to undirected)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if symmetric:
            s = np.concatenate([src, dst])
            d = np.concatenate([dst, src])
        else:
            s, d = src, dst
        key = np.unique(s * n_nodes + d)          # dedupe parallel edges
        s, d = key // n_nodes, key % n_nodes
        return cls.from_coo(s, d, np.ones_like(s, np.float32), (n_nodes, n_nodes))

    # -- row-wise operations ----------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)

    def row_ids(self) -> np.ndarray:
        """(nnz,) row index of every stored element."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int32), self.degrees())

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for dense X on X's device: gather the neighbour rows, then
        a segment sum over each row's contiguous run of stored elements.
        No atomics, so the result is the same on every call."""
        dev = X.device
        data = torch.from_numpy(self.data).to(dev, X.dtype)
        indices = torch.from_numpy(self.indices).to(dev, torch.int64)
        lengths = torch.from_numpy(self.degrees()).to(dev, torch.int64)
        contrib = data[:, None] * X[indices]                    # (nnz, w)
        return torch.segment_reduce(contrib, "sum", lengths=lengths, axis=0)

    def neighbor_padded(self, max_deg: int) -> Tuple[np.ndarray, np.ndarray]:
        """(n, max_deg) neighbour table padded with -1 + (n,) true degree.
        Used by the uniform neighbour sampler."""
        n = self.shape[0]
        table = np.full((n, max_deg), -1, np.int32)
        deg = self.degrees()
        rid = np.repeat(np.arange(n, dtype=np.int64), deg)
        pos = np.arange(self.indices.shape[0], dtype=np.int64) - self.indptr[rid]
        keep = pos < max_deg
        table[rid[keep], pos[keep]] = self.indices[keep]
        return table, deg
