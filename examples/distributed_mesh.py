"""Row-partitioned solve over a device mesh.

Uses every device of the default platform (e.g. four GPUs).  Without
several accelerators, run it on 8 virtual CPU devices:

    JAX_PLATFORMS=cpu python examples/distributed_mesh.py
"""

import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)
_devs = jax.devices()
if len(_devs) < 2:
    raise SystemExit(f"need >= 2 {_devs[0].platform} devices; on the CPU run "
                     "with JAX_PLATFORMS=cpu")

from arnoldi_jax import as_operator
from arnoldi_jax.matrices import laplace, laplace_eigen, mark
from arnoldi_jax.parallel import (
    banded_matvec_halo,
    make_mesh,
    shard_operator,
    sharded_partial_schur,
)


def main():
    mesh = make_mesh(devices=_devs)
    print(f"mesh: {mesh.devices.size} x {_devs[0].platform}")

    # Krylov-Schur with the operator + basis row-partitioned (GSPMD inserts
    # the psum for every Gram-Schmidt reduction).
    A = mark(50)
    tol = 1e-8
    Q, T, hist = sharded_partial_schur(
        A, 5, mesh=mesh, sort_function="LR", stopping_criterion=tol,
        max_restarts=2000,
    )
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = np.linalg.norm(A @ Qh - Qh @ Th, axis=0)
    print("sharded partial_schur residuals:", res)
    print("basis sharded over", len(Q.sharding.device_set), "devices")

    # Explicit halo-exchange SpMV (ppermute ring instead of all-gather).
    op = as_operator(laplace(1024).tocsr())
    sop = shard_operator(op, mesh)
    x = jax.device_put(
        np.random.default_rng(0).standard_normal(1024),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rows")),
    )
    y = banded_matvec_halo(sop, x, mesh)
    err = np.abs(np.asarray(y) - np.asarray(op.matvec(x))).max()
    print(f"halo-exchange SpMV max err vs dense path: {err:.2e}")


if __name__ == "__main__":
    main()
