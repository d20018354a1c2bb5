"""Data-parallel ranks over ``torch.distributed`` (``sharding``) and the
placement of a stacked sharded frontier on them (``policy``)."""

from repro_torch.parallel.sharding import (DataMesh, broadcast_bytes, current_mesh,
                                           data_axis, data_axis_size, data_mesh, group_mesh,
                                           group_ranks, spawn, use_sharding)

__all__ = ["DataMesh", "broadcast_bytes", "current_mesh", "data_axis", "data_axis_size",
           "data_mesh", "group_mesh", "group_ranks", "spawn", "use_sharding"]
