"""shard_map with the replication check off — the one place every mesh
wrapper of this package builds its shard_map."""
from __future__ import annotations

import jax


def shard_map_nocheck(f, *, mesh, in_specs, out_specs):
    """jax.shard_map with check_vma=False."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
