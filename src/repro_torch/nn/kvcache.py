"""Decode-time caches (counterpart of ``repro/nn/kvcache.py``).

``KVCache`` holds one attention site's (B, S_max, n_kv, d_head) key and
value buffers and the next write position.  ``pos`` is a Python int that
the host knows, so no decode step reads a scalar back from the card.

``update`` writes the new rows into the buffers in place and returns a
cache over the same buffers with ``pos`` advanced: the cache passed in is
consumed.  It keeps the JAX package's three branches: a write of S_max
rows replaces the whole buffer, one row writes one slot, anything else (a
chunked prefill) writes a slice at ``pos``.  JAX's one-hot merge for the
one-row write exists for GSPMD's partitioner; a slot write gives the same
values (±0 aside).  ``shard()`` is a sharding constraint and has no
counterpart here.

``SSMCache`` holds one Mamba2 layer's recurrent state (B, H, N, P) f32 and
its conv tail (B, W-1, C): the last W-1 inputs of the depthwise conv.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor      # (B, S_max, n_kv, d_head)
    v: torch.Tensor
    pos: int             # next write index (the same for every row)

    @classmethod
    def zeros(cls, batch: int, s_max: int, n_kv: int, d_head: int,
              dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None) -> "KVCache":
        dev = resolve_device(device)
        shape = (batch, s_max, n_kv, d_head)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), 0)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Append S_new timesteps (B, S_new, n_kv, d_head) at ``pos``."""
        s_new, s_max = k_new.shape[1], self.k.shape[1]
        if self.pos + s_new > s_max:
            raise ValueError(f"KV cache overflow: {self.pos} + {s_new} rows > S_max {s_max}")
        if s_new == s_max:
            self.k.copy_(k_new)
            self.v.copy_(v_new)
        elif s_new == 1:
            self.k[:, self.pos] = k_new[:, 0]
            self.v[:, self.pos] = v_new[:, 0]
        else:
            self.k[:, self.pos:self.pos + s_new] = k_new
            self.v[:, self.pos:self.pos + s_new] = v_new
        return KVCache(self.k, self.v, self.pos + s_new)

    def valid_mask(self) -> torch.Tensor:
        """(S_max,) bool: which cache slots hold live tokens."""
        return torch.arange(self.k.shape[1], device=self.k.device) < self.pos


@dataclasses.dataclass
class SSMCache:
    state: torch.Tensor      # (B, H, d_state, headdim) f32
    conv: torch.Tensor       # (B, conv_width - 1, conv_channels)

    @classmethod
    def zeros(cls, batch: int, n_heads: int, d_state: int, headdim: int,
              conv_width: int, conv_channels: int, dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> "SSMCache":
        dev = resolve_device(device)
        return cls(torch.zeros((batch, n_heads, d_state, headdim), dtype=dtype, device=dev),
                   torch.zeros((batch, conv_width - 1, conv_channels), dtype=dtype, device=dev))
