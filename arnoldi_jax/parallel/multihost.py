"""Multi-host execution helpers (SURVEY §7 L5).

Single-controller JAX covers one host; multi-host slices need
``jax.distributed`` initialization on every process plus a mesh that keeps
the heavy collectives on the fast links within a host rather than on the
network between hosts.
Nothing here can be exercised on a single machine — the helpers are
thin, deterministic wrappers so multi-host deployment is a configuration
change, not a code change:

* every process calls :func:`initialize` (idempotent),
* the row-partition axis is laid out host-major via :func:`make_slice_mesh`,
* everything else in the framework is sharding-transparent already.
"""

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize ``jax.distributed`` (idempotent, no-op when single
    process and no coordinator is configured)."""
    global _initialized
    if _initialized:
        return
    import os

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return  # single-process run: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True


def make_slice_mesh(axis_name="rows"):
    """1-D mesh over ALL global devices, ordered so that devices within a
    host/slice are adjacent — ring collectives (the halo exchange,
    psum reductions) then ride the intra-host links (NVLink) first and
    touch the network only at host boundaries."""
    devs = sorted(
        jax.devices(),
        key=lambda d: (d.process_index, getattr(d, "slice_index", 0), d.id),
    )
    return Mesh(np.array(devs), (axis_name,))


def process_local_rows(n, mesh, axis_name="rows", row_granularity=1):
    """The [start, stop) global row range owned by this process under the
    framework's row partition (for per-host data loading).

    Matches the solver's padding rule (``krylov_schur.partial_schur``): the
    row dimension is padded to a multiple of ``n_dev * row_granularity``
    (``row_granularity`` is the operator's block size — 8 for BSR-8, 1
    otherwise), so shard boundaries fall on multiples of the *padded*
    per-device size, clamped back to ``n``."""
    n_dev = int(mesh.devices.size)
    gran = n_dev * int(row_granularity)
    n_solve = -(-n // gran) * gran
    per_dev = n_solve // n_dev
    my = [i for i, d in enumerate(mesh.devices.flat)
          if d.process_index == jax.process_index()]
    if not my:
        return 0, 0
    return min(min(my) * per_dev, n), min((max(my) + 1) * per_dev, n)
