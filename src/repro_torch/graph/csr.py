"""Compressed-row-storage adjacency (paper §3.1: "it is preferred to store A
as a sparse matrix in CRS format as all the operations on A are row-wise").

Counterpart of ``repro/graph/csr.py``.  The matrix itself lives on the host
as numpy arrays (the generators and the neighbour sampler are numpy);
``matmat`` moves the arrays to the device of its dense operand and runs the
row-wise product there.  ``on(device)`` uploads them once instead: the
``DeviceCSR`` it returns is what the full-graph models multiply by every
step, a differentiable product whose backward is a fixed-order product by
the transpose (uploaded on the first backward).
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
        """A @ X for dense X, the arrays uploaded to X's device for the call
        (``on`` keeps them there).  No atomics, so the result is the same
        on every call."""
        return _rowwise(*_upload(self, X.device), X)

    def normalized(self, kind: str = "sym") -> "CSRMatrix":
        """Degree-normalised values on the same pattern: 'sym' ->
        d_i^-1/2 d_j^-1/2, 'row' -> d_i^-1 (add self loops first for GCN's
        D^-1/2 (A+I) D^-1/2).  The degrees are float32, as the JAX
        package's, so every value has its bits."""
        deg = np.maximum(self.degrees().astype(np.float32), np.float32(1.0))
        rid = self.row_ids()
        if kind == "sym":
            vals = self.data / np.sqrt(deg[rid] * deg[self.indices])
        elif kind == "row":
            vals = self.data / deg[rid]
        else:
            raise ValueError(kind)
        return CSRMatrix(vals.astype(np.float32), self.indices, self.indptr, self.shape)

    def with_self_loops(self) -> "CSRMatrix":
        """A + I: each row's stored elements, then its diagonal one."""
        n = self.shape[0]
        rows = np.concatenate([self.row_ids(), np.arange(n)])
        cols = np.concatenate([self.indices, np.arange(n)])
        vals = np.concatenate([self.data, np.ones(n, np.float32)])
        return CSRMatrix.from_coo(rows, cols, vals, self.shape)

    def transpose(self) -> "CSRMatrix":
        """Aᵀ, each of its rows in ascending column order of A's rows."""
        order = np.argsort(self.indices, kind="stable")
        rows = self.row_ids()[order]
        cols = self.indices[order]
        indptr = np.zeros(self.shape[1] + 1, np.int32)
        np.add.at(indptr, cols.astype(np.int64) + 1, 1)
        return CSRMatrix(self.data[order], rows.astype(np.int32),
                         np.cumsum(indptr, dtype=np.int32), (self.shape[1], self.shape[0]))

    def to_dense(self, device=None) -> torch.Tensor:
        """The (n_rows, n_cols) dense matrix on ``device`` (the CPU by
        default); duplicate entries add up."""
        out = np.zeros(self.shape, self.data.dtype)
        np.add.at(out, (self.row_ids(), self.indices), self.data)
        return torch.from_numpy(out).to(device or "cpu")

    def on(self, device) -> "DeviceCSR":
        """The matrix uploaded to ``device`` once (its transpose on the
        first backward)."""
        return DeviceCSR(self, torch.device(device))

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


def _upload(m: CSRMatrix, device: torch.device):
    """(values, column ids, row lengths) on ``device``."""
    return (torch.from_numpy(m.data).to(device),
            torch.from_numpy(m.indices).to(device, torch.int64),
            torch.from_numpy(m.degrees()).to(device, torch.int64))


def _rowwise(data: torch.Tensor, indices: torch.Tensor, lengths: torch.Tensor,
             X: torch.Tensor) -> torch.Tensor:
    """A @ X from A's arrays on X's device: gather the neighbour rows, then
    a segment sum over each row's contiguous run of stored elements."""
    contrib = data.to(X.dtype)[:, None] * X[indices]        # (nnz, w)
    return torch.segment_reduce(contrib, "sum", lengths=lengths, axis=0)


class DeviceCSR:
    """A ``CSRMatrix`` held on one device: its values, column ids and row
    lengths uploaded once, and those of its transpose on the first backward
    (built once on the host; a forward-only product never pays for it).
    ``matmat(X)`` is differentiable in X: the forward gives
    ``CSRMatrix.matmat``'s bits; the backward is Aᵀ·G by the same gather
    and segment sum over the transpose.  Neither adds with atomics or an
    accumulating ``index_put_``, so two calls give the same bits on either
    device."""

    def __init__(self, adj: CSRMatrix, device: torch.device):
        self.shape = adj.shape
        self.nnz = adj.nnz
        self.device = device
        self.arrays = _upload(adj, device)
        self._adj = adj
        self._t_arrays = None

    @property
    def t_arrays(self):
        if self._t_arrays is None:
            self._t_arrays = _upload(self._adj.transpose(), self.device)
        return self._t_arrays

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return _CSRProduct.apply(X, self)


class _CSRProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, mat: DeviceCSR):
        ctx.mat = mat
        return _rowwise(*mat.arrays, X)

    @staticmethod
    def backward(ctx, G):
        return _rowwise(*ctx.mat.t_arrays, G.contiguous()), None
