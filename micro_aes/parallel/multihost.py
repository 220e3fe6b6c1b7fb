"""Multi-host orchestration (SURVEY §2.6 "Multi-host launcher").

The reference is single-process by construction; here multi-host runs use
jax.distributed + a global (dp, sp) mesh spanning all hosts.  Each host
feeds its local shard of the message batch (host-local IO), and the only
cross-host traffic is the per-tag XOR-psum.

This module is exercised in-process via the virtual-device mesh
(tests/test_parallel.py, __graft_entry__.dryrun_multichip); on a cluster
call `init_distributed()` once per process before any jax use.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-based defaults (no-op if the
    runtime already initialized, e.g. under a pod launcher)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized
    except ValueError:
        # single process with no cluster environment: jax's env
        # auto-detection finds no coordinator address and raises
        # ValueError — the documented contract here is "initializes
        # trivially or no-ops", so a solo process just proceeds
        # uninitialized (every collective path works on the local mesh)
        pass


def global_mesh(dp: int | None = None, sp: int | None = None) -> Mesh:
    """(dp, sp) mesh over ALL devices of all hosts.  Defaults: sp = devices
    per host (block axis stays inside a host), dp = number of hosts
    (message batch crosses hosts) — the layout that keeps the tag psum on
    the fast in-host fabric."""
    devs = np.array(jax.devices())
    if dp is None or sp is None:
        sp = jax.local_device_count()
        dp = len(devs) // sp
    return Mesh(devs[: dp * sp].reshape(dp, sp), ("dp", "sp"))


def host_local_batch(mesh: Mesh, arrays):
    """Assemble a global sharded array from per-host local numpy shards
    (host-local IO: each process only touches its own slice)."""
    sharding = NamedSharding(mesh, P("dp"))
    return jax.make_array_from_process_local_data(sharding, np.asarray(arrays))
