"""Sharded solver execution.

Strategy: GSPMD. The operator's row-dimension buffers and the Krylov basis
``V`` are placed row-sharded over the mesh; the projected ``H`` and all
m-sized quantities are replicated.  The solver's jitted device functions
(Arnoldi expansion, truncation) are sharding-transparent, so XLA partitions
them and inserts the collectives (psum for Gram-Schmidt dot products and
norms, all-gather for the ELL column gather) — the standard
"pick a mesh, annotate shardings, let XLA do the rest" recipe.

The halo-exchange SpMV (``parallel/halo_spmv.py``: banded/blocked operators
with a ``ppermute`` ring) plugs in underneath this layer without changing
the solver.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..linop import (
    BandedOperator,
    BsrOperator,
    CallableOperator,
    DenseOperator,
    EllOperator,
)
from .mesh import make_mesh, replicated_sharding, row_sharding


def shard_operator(op, mesh):
    """Place an operator's buffers on the mesh, row-partitioned.

    * ELL: ``data``/``cols`` are (n, L) — shard rows.  The matvec's input
      gather turns into an all-gather of x.
    * Dense: shard the rows of A.
    * Banded: bands are (k, n) — shard the second (row) axis.
    """
    rows2 = row_sharding(mesh, 2)
    if isinstance(op, EllOperator):
        return EllOperator(
            jax.device_put(op.data, rows2),
            jax.device_put(op.cols, rows2),
            op.nnz_stored,
            op.n_cols,
        )
    if isinstance(op, DenseOperator):
        return DenseOperator(jax.device_put(op.A, rows2))
    if isinstance(op, BandedOperator):
        bands_spec = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, mesh.axis_names[0])
        )
        return BandedOperator(
            jax.device_put(op.bands, bands_spec), op.offsets, op.nnz_stored,
        )
    if isinstance(op, BsrOperator):
        spec4 = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(mesh.axis_names[0], None, None,
                                             None))
        return BsrOperator(
            jax.device_put(op.blocks, spec4),
            jax.device_put(op.block_cols, rows2),
            op.nnz_stored, op.n_cols, op.n_rows,
        )
    if isinstance(op, CallableOperator):
        return op  # closure decides its own placement
    raise TypeError(f"Cannot shard operator of type {type(op)}")


def shard_workspace(Vt, H, mesh):
    """Shard the transposed Krylov basis over its row dimension (axis 1 of
    ``Vt: (m+1, n)``), replicate the projected matrix."""
    vt_spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, mesh.axis_names[0])
    )
    return (
        jax.device_put(Vt, vt_spec),
        jax.device_put(H, replicated_sharding(mesh)),
    )


def sharded_partial_schur(A, nev, *, mesh=None, n_devices=None, **kwargs):
    """Run :func:`arnoldi_jax.partial_schur` with the operator and Krylov
    basis row-partitioned over a device mesh.

    Accepts everything ``partial_schur`` accepts.  ``mesh`` defaults to a
    1-D mesh over ``n_devices`` (or all devices).
    """
    from ..solvers.krylov_schur import partial_schur

    if mesh is None:
        mesh = make_mesh(n_devices)
    return partial_schur(A, nev, mesh=mesh, **kwargs)
