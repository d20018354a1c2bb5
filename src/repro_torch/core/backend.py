"""Pluggable decode backends for the paper's hot op (codes -> codebook sum).
Counterpart of the single-device part of ``repro/core/backend.py``.

    decode(codes (B, m) int32, codebooks (m, c, d_c), w0 (d_c,)?) -> (B, d_c) f32

Registered implementations:

  gather   m sequential gathers accumulated in f32 in codebook order — the
           bit-exactness oracle.
  onehot   one (B, m*c) x (m*c, d_c) f32 matmul.
  pallas   the hand-written Hopper ``hash_decode`` kernel
           (``kernels/hash_decode``), with its autograd backward.  It keeps
           the JAX package's name so a JAX ``RuntimeSpec`` selects its
           counterpart unchanged; on CPU tensors the wrapper runs the
           kernel's plain version.

Two more entries select another *compression family* (how the table is
parameterised) rather than another way to run the decode:

  hashemb  position-based hash embeddings (arXiv:2109.00101): m shared
           pools and per-position weights ``wpos``, folded into one
           (m, c, d_c) table before the call (``core.decoder``), so the
           decode is delegated verbatim to a base backend
           (``"hashemb:gather"`` pins it; none: ``auto``'s choice).
  tt       tensor-train codebooks (arXiv:2206.10581): the (m, c, d_c) table
           as two cores ``g0 (m, c1, d1, r)`` / ``g1 (m, c2, r, d2)``; the
           decode gathers both cores' rows and contracts them in f32, never
           forming the table (plain tensor code, as the JAX package's is
           XLA).

Two more wrap a base backend (``"sharded:pallas"``, ``"owner:gather"``;
none: ``auto``'s single-device choice) to decode across the ranks of the
active mesh (``parallel.sharding.use_sharding``), and degrade to the base
bit for bit without one:

  sharded  each rank decodes its block of the frontier rows and the rows
           are all-gathered; the codebook and ``w0`` gradients are the
           ranks' partials summed in rank order.
  owner    rows go to the rank that owns their id (``id % n``) by an
           all-to-all, each distinct id is decoded once, and a second
           all-to-all returns the rows; the routing is the batch's
           host-built ``OwnerPlan``.

``auto`` resolves to ``pallas`` on a CUDA device and to ``onehot`` on the
CPU, as the JAX package picks its kernel only on its accelerator; under a
mesh of several ranks to ``owner`` when the measured frontier duplication
beats ``OWNER_DUP_THRESHOLD``, else to ``sharded``.

Every backend carries a ``MixedPrecisionPolicy`` and states it in
``dtype_contract()``: codebooks may be stored f32, bf16, f16 or absmax-int8
(the kernel takes each as it is stored, int8 with its scales fused; gather,
onehot and tt widen them, and decode int8's dequantized values through
``quantize_dequantize``, which are the same f32 products), the gradient
goes straight through to the float masters, and the sum is always f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.hash_decode import ops as hd_ops
from repro_torch.parallel import sharding
from repro_torch.stages import stage

# Decode backends of later slices of the port (ROADMAP.md queue A): none.
NOT_PORTED: Dict[str, str] = {}

COLLECTIVE_BACKENDS = ("sharded", "owner")

# ``auto`` picks the owner-computes decode over the sharded one past this
# measured duplication (frontier_rows / unique_rows): beyond 2x the owner
# exchange reclaims more decode rows than its two all-to-alls cost, and
# ``graph.sampler.default_owner_caps``' owner_unique_cap = cap / 2 is
# adequate by the same inequality.
OWNER_DUP_THRESHOLD = 2.0

# Documented decode drift bounds vs the all-f32 path: max-abs output error
# <= bound * max-abs(f32 output) per decode.
DRIFT_BOUNDS = {"bfloat16": 1.5e-2, "int8": 5e-2}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Metadata consumed by selection logic and call-sites."""
    grad: bool = True            # differentiable w.r.t. codebooks / w0
    fused: bool = False          # single fused kernel
    accelerator: Tuple[str, ...] = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class MixedPrecisionPolicy:
    """Dtype contract of a decode path.

    ``param_dtype``    storage dtype of codebooks/w0 entering the decode
                       (None = whatever the caller passed)
    ``compute_dtype``  activation dtype of the caller (informational: the
                       decode always returns f32)
    ``reduce_dtype``   accumulation dtype; always float32
    ``quantize``       "none" | "int8" (absmax per (codebook, code))
    """
    param_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    reduce_dtype: str = "float32"
    quantize: str = "none"

    def __post_init__(self):
        if self.quantize not in ("none", "int8"):
            raise ValueError(
                f"quantize={self.quantize!r} not supported (expected 'none' "
                f"or 'int8')")
        if self.reduce_dtype != "float32":
            raise ValueError("reduce_dtype must be 'float32': every backend "
                             "accumulates in f32")


DEFAULT_POLICY = MixedPrecisionPolicy()


class DecodeBackend:
    """Protocol: subclasses set ``name``/``capabilities`` and implement
    ``decode``."""

    name: str = "abstract"
    capabilities = BackendCapabilities()
    policy: MixedPrecisionPolicy = DEFAULT_POLICY

    def __init__(self, policy: Optional[MixedPrecisionPolicy] = None):
        self.policy = policy or DEFAULT_POLICY

    def decode(self, codes: torch.Tensor, codebooks: torch.Tensor,
               w0: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def feature_dim(self, codebooks) -> int:
        """Output width ``d_c`` of ``decode`` for its ``codebooks`` operand:
        the dense layout's last dim (``tt``'s core pair overrides it)."""
        return int(codebooks.shape[2])

    def _prep(self, codebooks, w0):
        """Cast params to the policy's storage dtype; ``codebooks`` may be a
        tuple (``tt``'s core pair), whose every tensor is cast."""
        p = self.policy
        if p.param_dtype is not None:
            dt = torch_dtype(p.param_dtype)
            codebooks = (tuple(t.to(dt) for t in codebooks)
                         if isinstance(codebooks, tuple) else codebooks.to(dt))
            w0 = None if w0 is None else w0.to(dt)
        return codebooks, w0

    def _prep_values(self, codebooks, w0):
        """Storage cast, then the decode-visible int8 values (q * s), with
        the gradient straight through to the masters."""
        codebooks, w0 = self._prep(codebooks, w0)
        if self.policy.quantize == "int8":
            codebooks = hd_ops.quantize_dequantize(codebooks)
        return codebooks, w0

    def decode_frontier(self, codes: torch.Tensor, codebooks, w0=None, *, plan=None):
        """The frontier decode: ``decode``, except that under a mesh of
        several ranks ``codes`` is this rank's block of a placed frontier
        (``parallel.policy``) and every rank's rows come back, decoded the
        ``sharded`` way whatever the backend; ``plan`` is the frontier's
        ``graph.sampler.OwnerPlan`` slice, which only ``owner`` reads."""
        mesh = sharding.current_mesh()
        if sharding.data_axis_size(mesh) <= 1:
            return self.decode(codes, codebooks, w0)
        return _sharded_decode(self, mesh, codes, codebooks, w0)

    def dtype_contract(self) -> Dict[str, str]:
        """The backend's stated dtype contract (the JAX package's keys)."""
        p = self.policy
        storage = ("int8 values + float32 scales" if p.quantize == "int8"
                   else (p.param_dtype or "caller-provided"))
        return {"backend": self.name, "storage": storage,
                "compute": p.compute_dtype or "float32",
                "accumulate": p.reduce_dtype, "output": "float32"}


class GatherBackend(DecodeBackend):
    """Oracle: m sequential gathers, f32 accumulation in codebook order —
    the bits of the kernel's plain version (``ref.hash_decode_ref``) on the
    decode-visible values.  Each term is a ``_RowGather``, whose backward
    sums a codebook row's cotangents in ascending row order, so the
    gradient has the same bits on every run and thread count (an indexed
    read's backward, an accumulating ``index_put_``, adds them in a varying
    order on several CPU threads)."""

    name = "gather"

    def decode(self, codes, codebooks, w0=None):
        codebooks, w0 = self._prep_values(codebooks, w0)
        idx = codes.to(torch.int64)
        acc = _RowGather.apply(codebooks[0], idx[:, 0])
        for j in range(1, codebooks.shape[0]):
            acc = acc + _RowGather.apply(codebooks[j], idx[:, j])
        if w0 is not None:
            acc = acc * w0.float()[None, :]
        return acc


class OnehotBackend(DecodeBackend):
    """One-hot x stacked-codebook matmul: the sum over m is one
    (B, m*c) x (m*c, d_c) f32 contraction."""

    name = "onehot"

    def decode(self, codes, codebooks, w0=None):
        codebooks, w0 = self._prep_values(codebooks, w0)
        m, c, d_c = codebooks.shape
        B = codes.shape[0]
        iota = torch.arange(c, dtype=codes.dtype, device=codes.device)
        onehot = (codes[:, :, None] == iota).to(torch.float32)
        out = onehot.reshape(B, m * c) @ codebooks.float().reshape(m * c, d_c)
        if w0 is not None:
            out = out * w0.float()[None, :]
        return out


class KernelBackend(DecodeBackend):
    """The hand-written Hopper ``hash_decode`` kernel (registered as
    ``"pallas"``).  int8 storage goes to the kernel as int8 values plus the
    (m, c) scale table; it dequantizes in-register.  Any batch size and
    feature width run as they are (the kernel masks ragged edges).

    Differentiable: the wrapper's ``torch.autograd.Function`` gives the
    codebooks and ``w0`` their gradients on both devices; under int8 the
    codebook gradient goes straight through to the float masters."""

    name = "pallas"
    capabilities = BackendCapabilities(grad=True, fused=True)

    def decode(self, codes, codebooks, w0=None):
        codebooks, w0 = self._prep(codebooks, w0)
        scales = masters = None
        if self.policy.quantize == "int8":
            masters = codebooks
            codebooks, scales = hd_ops.quantize_codebooks(codebooks.detach())
        elif codebooks.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            codebooks = codebooks.float()
        return hd_ops.hash_decode(
            codes.to(torch.int32).contiguous(), codebooks.contiguous(),
            None if w0 is None else w0.float().contiguous(), scales, masters)


# ---------------------------------------------------------------------------
# collective decode (several ranks, parallel.sharding)
# ---------------------------------------------------------------------------

class _RankSum(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the mesh's
    ranks: the ranks' partials are all-gathered and added in f32 in
    ascending rank order, then rounded once to the gradient's dtype, so
    every rank gets the same bits on any backend (an ``all_reduce``'s order
    depends on the backend and its algorithm).  The JAX package's ``psum``
    of the disjoint f32 partials."""

    @staticmethod
    def forward(ctx, mesh, *params):
        ctx.mesh = mesh
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, need in zip(grads, ctx.needs_input_grad[1:]):
            if not need:            # a frozen table: the same on every rank
                out.append(None)
                continue
            parts = ctx.mesh.all_gather(g.float())
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            out.append(acc.to(g.dtype))
        return (None, *out)


class _GatherRows(torch.autograd.Function):
    """Every rank's (equal-sized) block of rows, stacked in rank order; the
    backward keeps this rank's block of the cotangent (every rank computes
    the same full cotangent, since all work after the decode runs on the
    whole batch on every rank)."""

    @staticmethod
    def forward(ctx, mesh, rows):
        ctx.mesh, ctx.n = mesh, rows.shape[0]
        return torch.cat(mesh.all_gather(rows))

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank
        return None, g[r * ctx.n:(r + 1) * ctx.n]


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all along dim 0; its own transpose, so the backward
    sends each cotangent block back the way its row came."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.all_to_all(g)


def _summed_over_ranks(mesh, codebooks, w0):
    """``codebooks`` (a tensor or ``tt``'s pair) and ``w0`` behind one
    ``_RankSum``, so each rank's decode gives its partial gradients and the
    backward sums them."""
    leaves = list(codebooks) if isinstance(codebooks, tuple) else [codebooks]
    if w0 is not None:
        leaves.append(w0)
    summed = list(_RankSum.apply(mesh, *leaves))
    w0 = summed.pop() if w0 is not None else None
    return (tuple(summed) if isinstance(codebooks, tuple) else summed[0]), w0


def _sharded_decode(base: DecodeBackend, mesh, codes_l, codebooks, w0):
    """This rank's block of rows decoded by ``base``, every rank's blocks
    all-gathered; the parameters' gradients are summed over the ranks."""
    cb, w0 = _summed_over_ranks(mesh, codebooks, w0)
    return _GatherRows.apply(mesh, base.decode(codes_l, cb, w0))


def table_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """A dense table's rows at ``ids`` (any shape), in the table's dtype;
    the backward sums each row's cotangents in f32 in a fixed order
    (``_RowGather``), so the table's gradient has the same bits on every
    run, where an indexed read's accumulating ``index_put_`` may not."""
    rows = _RowGather.apply(table, ids.reshape(-1).to(torch.int64)).to(table.dtype)
    return rows.reshape(*ids.shape, table.shape[1])


def frontier_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """A dense table's rows of a frontier: under a mesh of several ranks
    ``ids`` is this rank's block, and every rank's rows come back (the
    table's gradient summed over the ranks), as the decode backends' do."""
    mesh = sharding.current_mesh()
    if sharding.data_axis_size(mesh) <= 1:
        return table[ids]
    table, = _RankSum.apply(mesh, table)
    return _GatherRows.apply(mesh, table[ids])


def _check_collective_base(name: str, base: Optional[str]) -> None:
    if base is not None and base.split(":")[0] in COLLECTIVE_BACKENDS:
        raise ValueError(f"{name} backend cannot wrap itself or another collective "
                         f"backend (got base={base!r})")


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        import warnings
        warnings.warn(msg, stacklevel=3)


_WARNED: set = set()


class ShardedBackend(DecodeBackend):
    """Data-parallel decode: the frontier rows are partitioned over the
    active mesh's ranks and decoded there by the wrapped base backend
    against the replicated codebooks, then all-gathered, so every rank
    holds the whole batch's rows; the codebook and ``w0`` gradients are the
    ranks' partials summed in rank order.  A row's decode does not depend
    on where it runs, so an N-rank run decodes the 1-rank run's bits.

    ``decode`` takes the whole batch on every rank, pads its rows to a
    multiple of the rank count (warning once) and decodes this rank's
    slice; ``decode_frontier`` takes this rank's block of a placed
    frontier (as every backend's does).  Without a mesh (or with one rank)
    both are the base's decode."""

    name = "sharded"
    capabilities = BackendCapabilities(grad=True, fused=False)

    def __init__(self, base: Optional[str] = None,
                 policy: Optional[MixedPrecisionPolicy] = None, *, device: torch.device):
        _check_collective_base(self.name, base)
        self.base = get_backend(base or _single_device_auto(device), device=device,
                                policy=policy)
        self.policy = self.base.policy

    def dtype_contract(self) -> Dict[str, str]:
        return dict(self.base.dtype_contract(), backend=self.name,
                    collective_reduce="float32 (rank-ordered sum of codebook/w0 grads)")

    def feature_dim(self, codebooks) -> int:
        return self.base.feature_dim(codebooks)

    def decode(self, codes, codebooks, w0=None):
        mesh = sharding.current_mesh()
        k = sharding.data_axis_size(mesh)
        if k <= 1:
            return self.base.decode(codes, codebooks, w0)
        B = codes.shape[0]
        B_pad = -(-B // k) * k
        if B_pad != B:
            _warn_once(f"sharded-pad-b-{B}-{k}",
                       f"sharded decode: padding batch {B} -> {B_pad} to split over {k} "
                       f"shards; pad frontiers to a multiple of the shard count (e.g. "
                       f"frontier_cap) to avoid the copy")
            codes = torch.cat([codes, codes.new_zeros((B_pad - B, codes.shape[1]))])
        n = B_pad // k
        out = _sharded_decode(self.base, mesh, codes[mesh.rank * n:(mesh.rank + 1) * n],
                              codebooks, w0)
        return out[:B]

    def decode_frontier(self, codes, codebooks, w0=None, *, plan=None):
        return self.base.decode_frontier(codes, codebooks, w0)


def _owner_decode(base: DecodeBackend, mesh, codes_l, codebooks, w0, plan):
    """Owner-computes decode of this rank's ``cap``-row frontier block with
    its ``OwnerPlan`` slice (leading dim 1):

        requester: send[o, k] = codes[req_rows[o, k]]       -- all-to-all -->
        owner:     owned[j]   = recv[owned_src[j]]          (each id once)
                   dec        = base.decode(owned)
                   ret[s, k]  = dec[ret_idx[s, k]]           -- all-to-all -->
        requester: out[req_rows[o, k]] = back[o, k]         (sentinel cap masked)

    then the blocks are all-gathered as in the sharded decode.  Autograd
    runs the same route backwards: each requester's cotangent rows go back
    to their owner, which adds them onto its owned rows in ascending slot
    order (``_RowGather``'s sorted segment sum, no atomics) before one base
    backward, and the disjoint partials are summed over the ranks in rank
    order.  Padding rows decode to zeros."""
    rr, os_, ri = (t[0].to(torch.int64) for t in plan.leaves()[:3])
    n, oc = rr.shape
    cap = codes_l.shape[0]
    rows = rr.reshape(-1)
    keep = rows < cap                                   # the sentinel cap is no row
    send = codes_l.index_select(0, torch.where(keep, rows, torch.zeros_like(rows)))
    owned = mesh.all_to_all(send).index_select(0, os_)  # (ou, m)
    cb, w0 = _summed_over_ranks(mesh, codebooks, w0)
    dec = base.decode(owned, cb, w0)                    # each owned id once
    back = _AllToAll.apply(mesh, _RowGather.apply(dec, ri.reshape(-1)))   # (n*oc, d)
    out_l = dec.new_zeros((cap, dec.shape[1])).index_copy(0, rows[keep], back[keep])
    return _GatherRows.apply(mesh, out_l)


class OwnerBackend(DecodeBackend):
    """Owner-computes cross-shard frontier decode: the ``sharded`` backend
    decodes a node in k shards' frontiers k times; this one sends each
    row's request to the rank owning its id (``id % n``), which decodes
    every distinct id it owns exactly once, and sends the rows back
    (``_owner_decode``).  The routing is the batch's ``OwnerPlan``, built on
    the host in the prefetch producer with static shapes.

    Without a plan, without a mesh of several ranks, or with a plan for
    another rank count (warned once), it decodes as the ``sharded`` backend
    of the same base: the same values, without the dedup.  ``decode`` (the
    whole batch on every rank) is always that."""

    name = "owner"
    capabilities = BackendCapabilities(grad=True, fused=False)

    def __init__(self, base: Optional[str] = None,
                 policy: Optional[MixedPrecisionPolicy] = None, *, device: torch.device):
        _check_collective_base(self.name, base)
        self._fallback = ShardedBackend(base, policy, device=device)
        self.base = self._fallback.base
        self.policy = self.base.policy

    def dtype_contract(self) -> Dict[str, str]:
        return dict(self.base.dtype_contract(), backend=self.name,
                    collective_reduce="float32 (cotangent segment sum on owned rows + "
                                      "rank-ordered sum of grads)")

    def feature_dim(self, codebooks) -> int:
        return self.base.feature_dim(codebooks)

    def decode(self, codes, codebooks, w0=None):
        return self._fallback.decode(codes, codebooks, w0)

    def decode_frontier(self, codes, codebooks, w0=None, *, plan=None):
        mesh = sharding.current_mesh()
        k = sharding.data_axis_size(mesh)
        if plan is None or k <= 1:
            return self._fallback.decode_frontier(codes, codebooks, w0)
        if plan.n_shards != k or plan.req_rows.shape[0] != 1:
            _warn_once(f"owner-plan-mismatch-{plan.n_shards}-{k}",
                       f"owner decode: a plan for {plan.n_shards} shards (leading dim "
                       f"{plan.req_rows.shape[0]}) does not match this rank's slice of the "
                       f"{k}-rank mesh; falling back to the row-partitioned sharded decode")
            return self._fallback.decode_frontier(codes, codebooks, w0)
        return _owner_decode(self.base, mesh, codes, codebooks, w0, plan)


# ---------------------------------------------------------------------------
# compression families
# ---------------------------------------------------------------------------

FAMILY_BACKENDS = ("hashemb", "tt")


def family_of(lookup_impl: Optional[str]) -> str:
    """Compression family a ``lookup_impl`` string selects: "hashemb",
    "tt", or "paper" (every other spelling)."""
    for part in (lookup_impl or "auto").split(":"):
        if part in FAMILY_BACKENDS:
            return part
    return "paper"


class HashEmbBackend(DecodeBackend):
    """Position-based hash embeddings (arXiv:2109.00101).  What reaches it
    is the (m, c, d_c) table of pools already scaled by ``wpos``
    (``core.decoder`` folds them), so it decodes through its ``base``
    backend unchanged, int8 and bf16 policies included.  ``base`` None
    takes ``auto``'s choice for ``device``: the kernel on the card,
    ``onehot`` on the CPU."""

    name = "hashemb"
    capabilities = BackendCapabilities(grad=True, fused=False)

    def __init__(self, base: Optional[str] = None,
                 policy: Optional[MixedPrecisionPolicy] = None, *,
                 device: torch.device):
        base = base or _single_device_auto(device)
        if base.split(":")[0] in FAMILY_BACKENDS + COLLECTIVE_BACKENDS:
            raise ValueError(f"hashemb decodes through a plain backend, not {base!r}")
        self.base = get_backend(base, device=device, policy=policy)
        self.policy = self.base.policy

    def dtype_contract(self) -> Dict[str, str]:
        return dict(self.base.dtype_contract(), backend=self.name,
                    family="hashemb (pools + per-position weights)")

    def feature_dim(self, codebooks) -> int:
        return self.base.feature_dim(codebooks)

    def decode(self, codes, codebooks, w0=None):
        return self.base.decode(codes, codebooks, w0)


def tt_factor_pair(n: int) -> Tuple[int, int]:
    """Most balanced ``n = a * b`` with ``a <= b`` (a scans down from
    isqrt): the code split ``c = c1*c2`` and the feature split ``d_c =
    d1*d2`` of the ``tt`` family."""
    if n < 1:
        raise ValueError(f"cannot factor {n}")
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def tt_materialize(g0: torch.Tensor, g1: torch.Tensor) -> torch.Tensor:
    """The dense (m, c, d_c) table a core pair factorises, in f32:
    ``cb[j, x1*c2 + x2, u*d2 + v] = sum_r g0[j, x1, u, r] * g1[j, x2, r, v]``.
    The oracle of the tests, never on the decode path."""
    m, c1, d1, _ = g0.shape
    _, c2, _, d2 = g1.shape
    full = torch.einsum("jxur,jyrv->jxyuv", g0.float(), g1.float())
    return full.reshape(m, c1 * c2, d1 * d2)


class _RowGather(torch.autograd.Function):
    """``table[idx].float()`` for a 2-D table and 1-D ``idx``, whose
    backward sums each table row's cotangents in f32 in ascending position
    of ``idx`` (a stable sort, then ``segment_reduce``) and rounds once to
    the table's dtype: the same bits on every run.  ``F.embedding``'s CUDA
    backward adds the repeats of a row in an order that changes from run to
    run when a row repeats thousands of times, as a TT core's do."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table.index_select(0, idx).float()

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        order = torch.sort(idx, stable=True).indices
        # each row's repeats (bincount's values, with a shape known before
        # the data: a dry run traces this on tensors without storage)
        lengths = torch.zeros(ctx.rows, dtype=torch.int64, device=idx.device).scatter_add_(
            0, idx.to(torch.int64), torch.ones_like(idx, dtype=torch.int64))
        summed = torch.segment_reduce(g.float().index_select(0, order), "sum",
                                      lengths=lengths, axis=0)
        return summed.to(ctx.dtype), None


class TTBackend(DecodeBackend):
    """Tensor-train codebooks (arXiv:2206.10581): ``codebooks`` is the core
    pair ``(g0 (m, c1, d1, r), g1 (m, c2, r, d2))``.  A code splits as
    ``x1 = code // c2``, ``x2 = code % c2``; both cores' rows are gathered
    from the cores flattened to (m*c1, d1*r) and (m*c2, r*d2) (``_RowGather``:
    a fixed-order backward, no atomics) and one f32 batched product sums
    the rank and the m positions together: (B, d1, m*r) x (B, m*r, d2).
    The dense table is never formed."""

    name = "tt"
    capabilities = BackendCapabilities(grad=True, fused=False)

    def dtype_contract(self) -> Dict[str, str]:
        return dict(super().dtype_contract(),
                    family="tt (rank-r core pair, contraction fused)",
                    accumulate="float32 (core einsum + position sum)")

    def feature_dim(self, codebooks) -> int:
        g0, g1 = codebooks
        return int(g0.shape[2]) * int(g1.shape[3])

    def _quantized(self, g0, g1):
        """absmax int8 per (codebook, code row) of each core, straight
        through, as the dense tables are."""
        m, c1, d1, r = g0.shape
        _, c2, _, d2 = g1.shape
        g0 = hd_ops.quantize_dequantize(g0.reshape(m, c1, d1 * r)).reshape(m, c1, d1, r)
        g1 = hd_ops.quantize_dequantize(g1.reshape(m, c2, r * d2)).reshape(m, c2, r, d2)
        return g0, g1

    def decode(self, codes, codebooks, w0=None):
        (g0, g1), w0 = self._prep(tuple(codebooks), w0)
        if self.policy.quantize == "int8":
            g0, g1 = self._quantized(g0, g1)
        m, c1, d1, r = g0.shape
        _, c2, _, d2 = g1.shape
        B = codes.shape[0]
        codes = codes.to(torch.int64)
        base = torch.arange(m, dtype=torch.int64, device=codes.device)[None, :]
        a0 = _RowGather.apply(g0.reshape(m * c1, d1 * r), (base * c1 + codes // c2).reshape(-1))
        a1 = _RowGather.apply(g1.reshape(m * c2, r * d2), (base * c2 + codes % c2).reshape(-1))
        a0 = a0.reshape(B, m, d1, r).permute(0, 2, 1, 3).reshape(B, d1, m * r)
        out = torch.bmm(a0, a1.reshape(B, m * r, d2)).reshape(B, d1 * d2)
        if w0 is not None:
            out = out * w0.float()[None, :]
        return out


# ---------------------------------------------------------------------------
# registry / selection
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., DecodeBackend]] = {}


def register_backend(name: str, factory: Callable[..., DecodeBackend]) -> None:
    """Register a backend factory; ``factory(policy=...) -> DecodeBackend``."""
    _REGISTRY[name] = factory


register_backend("gather", GatherBackend)
register_backend("onehot", OnehotBackend)
register_backend("pallas", KernelBackend)
register_backend("hashemb", HashEmbBackend)
register_backend("tt", TTBackend)
register_backend("sharded", ShardedBackend)
register_backend("owner", OwnerBackend)


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def rederive_owner_caps(frontier_cap: int, n_shards: int,
                        explicit: Tuple[Optional[int], Optional[int]] = (None, None),
                        ) -> Tuple[Optional[int], Optional[int]]:
    """``(owner_cap, owner_unique_cap)`` for a (rescaled) shard count.  The
    caps depend on the count (request buckets shrink as shards multiply),
    so a rescale never carries them over: caps never pinned (both ``None``)
    stay derived, ``(None, None)``; pinned ones are derived again by
    ``default_owner_caps`` at the new count, which keeps its cap / 2
    adequacy argument."""
    if explicit[0] is None and explicit[1] is None:
        return (None, None)
    from repro_torch.graph.sampler import default_owner_caps
    return default_owner_caps(int(frontier_cap), int(n_shards))


def _single_device_auto(device: torch.device) -> str:
    return "pallas" if torch.device(device).type == "cuda" else "onehot"


def resolve_auto(device: torch.device, duplication: Optional[float] = None) -> str:
    """``auto``: under an active mesh of several ranks, ``owner`` when the
    measured frontier ``duplication`` beats ``OWNER_DUP_THRESHOLD`` and
    ``sharded`` otherwise; on one device the hand-written kernel on a CUDA
    device and the one-hot matmul on the CPU."""
    if sharding.data_axis_size() > 1:
        if duplication is not None and duplication > OWNER_DUP_THRESHOLD:
            return "owner"
        return "sharded"
    return _single_device_auto(device)


def get_backend(spec, *, device: torch.device,
                policy: Optional[MixedPrecisionPolicy] = None,
                duplication: Optional[float] = None) -> DecodeBackend:
    """Resolve a backend from a config string (or pass an instance through).
    ``device`` is where the decode will run (it decides ``auto``, also as
    a wrapper's base); ``duplication`` is the measured frontier duplication
    ``auto`` reads under a mesh.  ``sharded``, ``owner`` and ``hashemb``
    take an option, their base: ``"owner:gather"``, ``"hashemb:gather"``."""
    if isinstance(spec, DecodeBackend):
        return spec
    name = spec or "auto"
    if name == "auto":
        name = resolve_auto(device, duplication)
    base, _, option = name.partition(":")
    if base in NOT_PORTED:
        raise NotImplementedError(
            f"decode backend {name!r} is not ported yet; it comes with "
            f"{NOT_PORTED[base]}")
    if base not in _REGISTRY:
        raise ValueError(
            f"unknown decode backend {name!r}; known: {available_backends()}")
    if base in ("hashemb",) + COLLECTIVE_BACKENDS:
        return _REGISTRY[base](base=option or None, policy=policy, device=device)
    if option:
        raise ValueError(f"decode backend {base!r} takes no ':{option}' option")
    return _REGISTRY[base](policy=policy)


# ---------------------------------------------------------------------------
# hot-node cache
# ---------------------------------------------------------------------------

INT32_MIN_HALF = torch.iinfo(torch.int32).min // 2   # an empty slot's version and LRU stamp
INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class CacheState:
    """State of the hot-node decode cache: tensors on the cache's device, in
    the JAX package's field order (the checkpoint keys its leaves by that
    order: ``cache/0`` ... ``cache/7``, as the JAX package's pytree does).

    ``node_ids``   (C,) int32 entity id per slot (-1 = empty)
    ``values``     (C, d) cached decoded embeddings in the compute dtype
    ``version``    (C,) int32 codebook version each entry was decoded at
    ``last_used``  (C,) int32 LRU clock of the last access
    ``version_counter`` () int32 current codebook version (bumped per
                   optimizer update)
    ``clock``      () int32 access counter driving the LRU order
    ``hits`` / ``misses`` () int32 cumulative accounting
    """

    node_ids: torch.Tensor
    values: torch.Tensor
    version: torch.Tensor
    last_used: torch.Tensor
    version_counter: torch.Tensor
    clock: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor

    @classmethod
    def create(cls, capacity: int, d: int, dtype=torch.float32,
               device=None) -> "CacheState":
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            node_ids=torch.full((capacity,), -1, **i32),
            values=torch.zeros((capacity, d), dtype=dtype, device=device),
            version=torch.full((capacity,), INT32_MIN_HALF, **i32),
            last_used=torch.full((capacity,), INT32_MIN_HALF, **i32),
            version_counter=torch.zeros((), **i32),
            clock=torch.zeros((), **i32),
            hits=torch.zeros((), **i32),
            misses=torch.zeros((), **i32),
        )

    @property
    def capacity(self) -> int:
        return self.node_ids.shape[0]

    def head(self, n: int) -> "CacheState":
        """The first ``n`` slots (views of this state's tensors) with the
        same counters: ``CacheState.create(C + 1, ...).head(C)`` is a cache
        of C slots whose spare last row lets ``lookup_missonly(...,
        buffers=)`` write in place."""
        return dataclasses.replace(self, **{f: getattr(self, f)[:n] for f in _SLOT_FIELDS})

    def bookkeeping(self) -> Dict[str, object]:
        """Everything but the values, on the host (numpy arrays and ints):
        what ``HostCacheShadow`` replicates."""
        return {"node_ids": self.node_ids.cpu().numpy(),
                "version": self.version.cpu().numpy(),
                "last_used": self.last_used.cpu().numpy(),
                "version_counter": int(self.version_counter),
                "clock": int(self.clock)}


_SLOT_FIELDS = ("node_ids", "values", "version", "last_used")


def _first_slots(node_ids: torch.Tensor, ids: torch.Tensor):
    """(found, slot): whether each id is held, and the lowest slot holding
    it — what ``argmax`` of the (U, C) compare ``ids[:, None] ==
    node_ids[None, :]`` gives, from a stable sort and a left search instead
    of the (U, C) matrix.  Empty slots hold -1 and ids are >= 0, so an
    empty slot never matches; ``slot`` of an id that is not found is any
    slot (it only passes through masks)."""
    keys, order = torch.sort(node_ids, stable=True)
    pos = torch.searchsorted(keys, ids).clamp_(max=keys.shape[0] - 1)
    return keys[pos] == ids, order[pos]


def _spare_row(buf: torch.Tensor, buffers: Optional[CacheState], name: str) -> torch.Tensor:
    """``buf`` with one spare last row for the dropped writes: a new copy,
    or the field ``name`` of ``buffers`` (C + 1 rows whose first C are
    ``buf``'s own storage), which is then written in place."""
    return torch.cat([buf, buf[:1]]) if buffers is None else getattr(buffers, name)


def _write_index(state: CacheState, last_used, found, slot, hit, needs_slot, may_write):
    """The slot each row writes back to (C = no write).  Stale-but-present
    rows refresh in place; absent ones (``needs_slot``) take the least
    recently used unprotected slots, stable in slot order among ties (empty
    slots, protected slots), and only the first ``n_free`` of them get one;
    only ``may_write`` rows write.  The written slots are distinct."""
    C = state.capacity
    drop = torch.full_like(slot, C)
    protected = torch.zeros(C + 1, dtype=torch.bool, device=slot.device)
    protected[torch.where(found, slot, drop)] = True
    protected = protected[:C]
    n_free = C - protected.sum()
    evict_order = torch.argsort(
        torch.where(protected, torch.full_like(last_used, INT32_MAX), last_used),
        stable=True)
    rank = torch.cumsum(needs_slot.to(torch.int64), 0) - 1
    new_slot = evict_order[rank.clamp(0, C - 1)]
    write = may_write & (found | (needs_slot & (rank < n_free)))
    return torch.where(write, torch.where(found, slot, new_slot), drop)


class CachedDecodeBackend:
    """LRU cache of decoded embeddings keyed by entity id, around any decode
    function (counterpart of the JAX package's ``CachedDecodeBackend``,
    bit for bit in outputs and state).

    ``lookup(state, ids, decode_fn)`` serves each id from the cache when its
    entry is fresh enough (``version_counter - entry_version <= staleness``)
    and re-decodes otherwise; re-decoded rows are written back (LRU
    eviction), hit rows only refresh their LRU stamp.  Gradients flow
    through ``decode_fn`` for misses only: cached rows are constants from
    an earlier version.  Each call returns a new ``CacheState`` and leaves
    the old one as it was, unless ``lookup_missonly`` is given ``buffers``
    to write in place.

    Ids within one lookup should be unique among the ``valid`` rows; at
    ``staleness=0`` with one lookup per optimizer step every access
    re-decodes, so training is bit for bit the uncached path's."""

    def __init__(self, staleness: int = 0):
        self.staleness = int(staleness)

    def init_state(self, capacity: int, d: int, dtype=torch.float32,
                   device=None) -> CacheState:
        return CacheState.create(capacity, d, dtype, device)

    @staticmethod
    def dtype_contract(base: Optional[DecodeBackend] = None) -> Dict[str, str]:
        """The cache layer's dtype contract: misses take the base backend's
        contract end to end; hits are served from ``CacheState.values``,
        stored in the model's compute dtype, so a cached hit adds one
        compute-dtype round trip to the base's drift bound and nothing
        else.  The hit/miss select and the bookkeeping are dtype-free."""
        contract = {
            "backend": "cached",
            "storage": "CacheState.values in compute dtype (hits); "
                       "base backend storage (misses)",
            "compute": "base backend",
            "accumulate": "float32 (base backend)",
            "output": "float32",
        }
        if base is not None:
            contract["base"] = base.dtype_contract()["backend"]
        return contract

    def _classify(self, state: CacheState, ids: torch.Tensor, valid):
        found, slot = _first_slots(state.node_ids, ids)
        if valid is not None:
            found = found & valid
        age = state.version_counter - state.version[slot]
        return found, slot, found & (age <= self.staleness)

    def _commit(self, state: CacheState, ids, fresh, found, slot, hit, valid,
                n_decode: Optional[int] = None,
                buffers: Optional[CacheState] = None) -> CacheState:
        """The state after the lookup: hits refresh their LRU stamp, and
        rows that decoded (all, or the first ``n_decode``) are written
        back; with ``n_decode == 0`` nothing is written."""
        C, U = state.capacity, ids.shape[0]
        clock = state.clock + 1
        drop = torch.full_like(slot, C)
        last_used = _spare_row(state.last_used, buffers, "last_used")
        last_used[torch.where(hit, slot, drop)] = clock
        n_valid = U if valid is None else valid.sum(dtype=torch.int32)
        n_hit = hit.sum(dtype=torch.int32)
        counters = dict(version_counter=state.version_counter, clock=clock,
                        hits=state.hits + n_hit, misses=state.misses + (n_valid - n_hit))
        if n_decode == 0:
            return CacheState(node_ids=state.node_ids, values=state.values,
                              version=state.version, last_used=last_used[:C], **counters)
        needs_slot, may_write = ~found, ~hit
        if valid is not None:
            needs_slot = needs_slot & valid
        if n_decode is not None:
            decoded = torch.arange(U, device=ids.device) < n_decode
            needs_slot, may_write = needs_slot & decoded, may_write & decoded
        widx = _write_index(state, last_used[:C], found, slot, hit, needs_slot, may_write)

        def put(name, src):
            out = _spare_row(getattr(state, name), buffers, name)
            out.index_copy_(0, widx, src.to(out.dtype))
            return out[:C]
        last_used.index_copy_(0, widx, clock.expand(U))
        return CacheState(node_ids=put("node_ids", ids), values=put("values", fresh.detach()),
                          version=put("version", state.version_counter.expand(U)),
                          last_used=last_used[:C], **counters)

    def lookup(self, state: CacheState, ids: torch.Tensor,
               decode_fn: Callable[[torch.Tensor], torch.Tensor],
               valid: Optional[torch.Tensor] = None):
        """ids (U,) -> ((U, d) embeddings, new CacheState).  ``valid`` (U,)
        bool masks rows out of the cache (they still decode, but never hit,
        never write and do not count): the frontier's padding rows."""
        with stage("lookup"):
            ids = ids.to(torch.int32)
            found, slot, hit = self._classify(state, ids, valid)
        fresh = decode_fn(ids)
        with stage("writeback"):
            out = torch.where(hit[:, None], state.values[slot].to(fresh.dtype), fresh)
            return out, self._commit(state, ids, fresh, found, slot, hit, valid)

    @staticmethod
    def plan_missonly(cached_ids, ids, valid=None):
        """Host-side miss partition for ``lookup_missonly``: ``(perm,
        n_miss)``, a stable permutation of ``ids`` placing every row that
        will miss (valid and not among ``cached_ids``; negative ids, empty
        slots, are ignored) first, and the count of such rows.  Membership
        is read from a table of bools indexed by id, which gives
        ``np.isin``'s answer without sorting."""
        ids = np.asarray(ids)
        if valid is None:
            valid = np.ones(ids.shape[0], bool)
        cached_ids = np.maximum(np.asarray(cached_ids), -1)
        size = 1 + max(int(ids.max(initial=-1)), int(cached_ids.max(initial=-1)))
        held = np.zeros(size + 1, bool)   # every empty slot (-1) marks the spare last entry
        held[cached_ids] = True
        return CachedDecodeBackend.partition(np.asarray(valid, bool) & ~held[ids])

    @staticmethod
    def partition(miss: np.ndarray):
        """``(perm, n_miss)``: ``argsort(~miss, kind="stable")``, the rows
        flagged in ``miss`` first, each part in row order."""
        return np.argsort(~miss, kind="stable").astype(np.int32), int(miss.sum())

    @staticmethod
    def miss_bucket(n_miss: int, pad_to: int, cap: int) -> int:
        """``n_decode`` for ``n_miss`` planned misses: 0, or ``pad_to``
        doubled until it holds them, capped at the frontier's ``cap`` rows
        (the JAX package's jit-shape buckets, kept so both packages decode
        the same rows)."""
        if n_miss <= 0:
            return 0
        b = pad_to
        while b < n_miss:
            b *= 2
        return min(b, cap)

    def lookup_missonly(self, state: CacheState, ids: torch.Tensor,
                        decode_fn: Callable[[torch.Tensor], torch.Tensor],
                        n_decode: int, valid: Optional[torch.Tensor] = None,
                        buffers: Optional[CacheState] = None):
        """Miss-only twin of ``lookup``: ``decode_fn`` runs only on the first
        ``n_decode`` rows (not at all when it is 0).  The caller permuted
        ``ids`` miss-first (``plan_missonly``), so every valid row past the
        prefix is a fresh hit; prefix rows that hit anyway are served from
        the cache, which keeps the output ``lookup``'s.  State updates are
        restricted to the decoded prefix.

        ``buffers`` (C + 1 rows, ``state`` its ``head(C)``; see
        ``CacheState.head``) makes the update in place: the returned state's
        slots are views of ``buffers`` and ``state`` no longer holds the old
        contents.  A caller that owns its cache alone (the serving engine)
        saves a copy of every slot tensor a call; the bits are the same."""
        with stage("lookup"):
            ids = ids.to(torch.int32)
            U, d = ids.shape[0], state.values.shape[1]
            found, slot, hit = self._classify(state, ids, valid)
        if n_decode > 0:
            prefix = decode_fn(ids[:n_decode])
        with stage("writeback"):
            fresh = (torch.cat([prefix, prefix.new_zeros((U - n_decode, d))])
                     if n_decode > 0 else state.values.new_zeros((U, d)))
            out = torch.where(hit[:, None], state.values[slot].to(fresh.dtype), fresh)
            return out, self._commit(state, ids, fresh, found, slot, hit, valid,
                                     n_decode, buffers)

    @staticmethod
    def bump_version(state: CacheState) -> CacheState:
        """Codebook/decoder update notification: once per optimizer step
        that touches decoder parameters."""
        return dataclasses.replace(state, version_counter=state.version_counter + 1)


def _stable_argsort(a: np.ndarray) -> np.ndarray:
    """``np.argsort(a, kind="stable")`` for int32 ``a``: each value widened
    to int64 and tagged with its position makes every key distinct, so an
    unstable sort of the keys gives the stable order (several times faster
    than numpy's stable sort of int32)."""
    n = a.shape[0]
    return np.sort(a.astype(np.int64) * n + np.arange(n, dtype=np.int64)) % n


class HostCacheShadow:
    """Host-side numpy replica of the ``CacheState`` bookkeeping (never the
    values), used to plan miss-only decode for training
    (``graph.engine.MissPlanningSource``).

    The bookkeeping depends only on the ``(ids, valid, n_decode)`` sequence,
    never on decoded values, so a replica fed the same per-step inputs
    tracks the device cache exactly: ``update`` mirrors
    ``CachedDecodeBackend.lookup_missonly``'s state update (the same stable
    sorts and slot assignment) followed by the train step's
    ``bump_version``.  A predicted miss that hits is harmless; a predicted
    hit that misses would read zeros, which is why ``clear()`` resets to the
    empty shadow (everything a miss) and ``sync_from_cache_state``
    re-anchors it to a restored device cache."""

    _EMPTY = INT32_MIN_HALF   # matches CacheState.create

    def __init__(self, capacity: int, staleness: int = 0):
        self.capacity = int(capacity)
        self.staleness = int(staleness)
        self.clear()

    def clear(self) -> None:
        C = self.capacity
        self.node_ids = np.full((C,), -1, np.int32)
        self.version = np.full((C,), self._EMPTY, np.int32)
        self.last_used = np.full((C,), self._EMPTY, np.int32)
        self.version_counter = 0
        self.clock = 0

    # -- (de)serialisation ----------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """A copy of the shadow (the arrays as numpy copies; the checkpoint
        writes them to its JSON manifest as lists)."""
        return {
            "capacity": self.capacity, "staleness": self.staleness,
            "node_ids": self.node_ids.copy(),
            "version": self.version.copy(),
            "last_used": self.last_used.copy(),
            "version_counter": int(self.version_counter),
            "clock": int(self.clock),
        }

    def restore(self, snap: Dict[str, object]) -> None:
        if int(snap["capacity"]) != self.capacity:
            raise ValueError(
                f"shadow snapshot capacity {snap['capacity']} != {self.capacity}")
        self.staleness = int(snap["staleness"])
        self.node_ids = np.array(snap["node_ids"], np.int32)
        self.version = np.array(snap["version"], np.int32)
        self.last_used = np.array(snap["last_used"], np.int32)
        self.version_counter = int(snap["version_counter"])
        self.clock = int(snap["clock"])

    def sync_from_cache_state(self, state: CacheState) -> None:
        """Re-anchor to a device cache (exact: same fields, host copies)."""
        book = state.bookkeeping()
        self.node_ids = book["node_ids"].astype(np.int32)
        self.version = book["version"].astype(np.int32)
        self.last_used = book["last_used"].astype(np.int32)
        self.version_counter = book["version_counter"]
        self.clock = book["clock"]

    # -- planning --------------------------------------------------------
    def fresh_ids(self) -> np.ndarray:
        """Ids whose cached entry will still be within the staleness budget
        at the next lookup (the shadow is post-bump, like the device)."""
        live = self.node_ids >= 0
        fresh = (self.version_counter - self.version.astype(np.int64)) <= self.staleness
        return self.node_ids[live & fresh]

    def plan(self, ids: np.ndarray, valid: np.ndarray):
        """``(perm, n_miss)`` for the next batch: ``plan_missonly`` against
        the fresh (not merely present) shadow entries."""
        return CachedDecodeBackend.plan_missonly(self.fresh_ids(), ids, valid)

    # -- state transition ------------------------------------------------
    def update(self, ids: np.ndarray, valid: np.ndarray, n_decode: int) -> None:
        """Replay one training step's cache transition: the bookkeeping of
        ``lookup_missonly(ids, ..., n_decode, valid)`` plus the optimizer's
        ``bump_version``.  ``ids``/``valid`` are the permuted arrays the
        device step sees."""
        C = self.capacity
        ids = np.asarray(ids, np.int32)
        valid = np.asarray(valid, bool)
        U = ids.shape[0]
        order = _stable_argsort(self.node_ids)
        keys = self.node_ids[order]
        pos = np.minimum(np.searchsorted(keys, ids, side="left"), C - 1)
        found = (keys[pos] == ids) & valid
        slot = order[pos]
        age = self.version_counter - self.version[slot].astype(np.int64)
        hit = found & (age <= self.staleness)
        decoded = np.arange(U) < int(n_decode)

        self.clock += 1
        last_used = self.last_used.copy()
        last_used[slot[hit]] = self.clock                      # hit refresh

        protected = np.zeros((C,), bool)
        protected[slot[found]] = True
        n_free = C - int(protected.sum())
        # the device's argsort is stable: so is this one, which keeps the
        # slot assignment bit for bit through the INT32_MAX / empty-slot ties
        evict_order = _stable_argsort(
            np.where(protected, np.iinfo(np.int32).max, last_used))
        needs_slot = ~found & decoded & valid
        rank = np.cumsum(needs_slot) - 1
        new_slot = evict_order[np.clip(rank, 0, C - 1)]
        write = ~hit & decoded & (found | (needs_slot & (rank < n_free)))
        w = np.where(found, slot, new_slot)[write]
        self.node_ids[w] = ids[write]
        self.version[w] = self.version_counter
        last_used[w] = self.clock
        self.last_used = last_used
        self.version_counter += 1                              # bump_version
