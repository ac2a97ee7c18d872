"""Halo-exchange banded SpMV over a device mesh.

The GSPMD path lets XLA insert an all-gather of ``x`` for the operator
matvec; for banded/stencil matrices that is wasteful — each shard only
needs a halo of ``max|offset|`` rows from its two ring neighbours.  This
module implements the explicit version with ``shard_map`` + ``ppermute``
(two ring sends to the neighbouring devices instead of an all-gather), the CP/ring-attention
analogue for eigensolvers (SURVEY §2b).

Correctness at the global edges: :class:`arnoldi_jax.linop.BandedOperator`
stores zero band entries wherever ``i + offset`` falls outside the matrix,
so the wrapped-around ring halo values are always multiplied by zero there.

Compute/communication overlap (``overlap=True``, the default): the naive
structure feeds the ``ppermute`` results straight into a ``concatenate``
that every downstream op consumes, so the compiled schedule cannot start
any FLOPs until the collective lands.  The overlapped variants instead run
the FULL local matvec against a zero-padded window — no data dependency on
the collective, so XLA schedules it between ``collective-permute-start``
and ``-done`` — and then recompute only the ``halo`` boundary rows with
the true neighbour window once it arrives.  Extra work: 2*halo of n_local
rows; hidden work: the entire interior.  (A Pallas
``make_async_remote_copy`` version could additionally overlap the
boundary fix-up, but start/done hoisting already covers the dominant
term.)
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..linop import BandedOperator


def banded_matvec_halo(op: BandedOperator, x, mesh, axis_name="rows",
                       overlap=True):
    """Distributed banded matvec ``y = A @ x`` with ring halo exchange.

    ``op.bands`` must be sharded ``P(None, axis_name)`` and ``x``
    ``P(axis_name)`` (as produced by ``arnoldi_jax.parallel.shard_operator``);
    the row count must divide the mesh size.  Returns ``y`` sharded like
    ``x``.  ``overlap=True`` computes the interior against a zero-padded
    window while the halo ``ppermute`` is in flight (see module docstring).
    """
    offsets = op.offsets
    halo = int(max((abs(int(o)) for o in offsets), default=0))
    n = op.shape[0]
    n_dev = int(mesh.devices.size)
    assert n % n_dev == 0, "shard rows first (pad_operator)"
    n_local = n // n_dev
    assert halo <= n_local, (
        f"halo {halo} exceeds shard size {n_local}; use fewer devices or "
        "the gather path"
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )
    def mv(bands_loc, x_loc):
        d = lax.axis_size(axis_name)
        fwd = [(i, (i + 1) % d) for i in range(d)]   # send right
        bwd = [(i, (i - 1) % d) for i in range(d)]   # send left
        # our right halo = left edge of the right neighbour (comes backward)
        right_halo = lax.ppermute(x_loc[:halo], axis_name, bwd)
        # our left halo = right edge of the left neighbour (comes forward).
        # Explicit start (NOT x_loc[-halo:]): halo == 0 (purely diagonal
        # stored sparsity) must select an EMPTY window, not the whole shard.
        left_halo = lax.ppermute(x_loc[n_local - halo:], axis_name, fwd)
        ydt = jnp.result_type(bands_loc.dtype, x_loc.dtype)
        pad = jnp.zeros(halo, x_loc.dtype)

        def shift_add(x_ext, rows, row0):
            acc = jnp.zeros(rows, ydt)
            for k, off in enumerate(offsets):
                seg = lax.dynamic_slice_in_dim(x_ext, halo + off + row0,
                                               rows)
                band = lax.dynamic_slice_in_dim(bands_loc[k], row0, rows)
                acc = acc + band * seg
            return acc

        if not overlap:
            x_ext = jnp.concatenate([left_halo, x_loc, right_halo])
            return shift_add(x_ext, n_local, 0)

        # Interior pass against the zero-padded window: correct for every
        # row >= halo from either shard edge, no dependency on the
        # collectives — XLA runs it between permute-start and -done.
        x_pad = jnp.concatenate([pad, x_loc, pad])
        y = shift_add(x_pad, n_local, 0)
        # Boundary fix-up once the halos land (2*halo rows).
        x_ext = jnp.concatenate([left_halo, x_loc, right_halo])
        y = y.at[:halo].set(shift_add(x_ext, halo, 0))
        y = y.at[n_local - halo:].set(shift_add(x_ext, halo, n_local - halo))
        return y

    return mv(op.bands, x)


def sparsity_bandwidth(op):
    """Max |col - row| over stored entries — the halo width a row
    partition needs (in rows for ELL, in BLOCK rows for BSR)."""
    import numpy as np

    from ..linop import BsrOperator, EllOperator

    if isinstance(op, EllOperator):
        cols = np.asarray(op.cols)
        rows = np.arange(cols.shape[0])[:, None]
        live = np.asarray(op.data) != 0
        return int(np.abs(np.where(live, cols - rows, 0)).max(initial=0))
    if isinstance(op, BsrOperator):
        bcols = np.asarray(op.block_cols)
        brows = np.arange(bcols.shape[0])[:, None]
        live = np.any(np.asarray(op.blocks) != 0, axis=(2, 3))
        return int(np.abs(np.where(live, bcols - brows, 0)).max(initial=0))
    if isinstance(op, BandedOperator):
        return int(max((abs(int(o)) for o in op.offsets), default=0))
    raise TypeError(type(op).__name__)


def ell_matvec_halo(op, x, mesh, axis_name="rows", halo=None, overlap=True):
    """Distributed ELL matvec with ring halo exchange (general scattered
    sparsity whose reach from the diagonal is bounded by ``halo``).

    The reference's MPI analog materializes the whole vector per rank
    (``/root/reference/scripts/utils.py:212-235`` PETSc row distribution);
    GSPMD's default here is an all-gather of ``x``.  Instead each shard
    receives only a ``halo``-row window from its two ring neighbours
    (``ppermute``) and remaps its OWN stored global column ids
    into the local extended window — index arithmetic inside ``shard_map``,
    no gather of remote structure, no all-gather of values.
    """
    from ..linop import EllOperator

    assert isinstance(op, EllOperator)
    if halo is None:
        halo = sparsity_bandwidth(op)
    n = op.shape[0]
    n_dev = int(mesh.devices.size)
    assert n % n_dev == 0, "shard rows first (pad_operator)"
    n_local = n // n_dev
    assert halo <= n_local, (
        f"halo {halo} exceeds shard size {n_local}; use fewer devices or "
        "the gather path")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P(axis_name)),
        out_specs=P(axis_name),
    )
    def mv(data_loc, cols_loc, x_loc):
        d = lax.axis_size(axis_name)
        me = lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % d) for i in range(d)]
        bwd = [(i, (i - 1) % d) for i in range(d)]
        right_halo = lax.ppermute(x_loc[:halo], axis_name, bwd)
        # explicit start: halo == 0 must give an empty window (see banded)
        left_halo = lax.ppermute(x_loc[n_local - halo:], axis_name, fwd)

        def ext_rows(data_r, cols_r, x_ext):
            # Global -> local-extended column remap.  Padding slots point
            # at global column 0; their data is zero, so clamping keeps
            # them in-range without affecting the result.
            local = jnp.clip(cols_r - me * n_local + halo,
                             0, x_ext.shape[0] - 1)
            return jnp.sum(data_r * jnp.take(x_ext, local, axis=0), axis=1)

        if not overlap:
            x_ext = jnp.concatenate([left_halo, x_loc, right_halo])
            return ext_rows(data_loc, cols_loc, x_ext)

        # Interior pass: gather from the LOCAL shard only (out-of-shard
        # slots masked to zero) — independent of the in-flight permutes.
        local0 = cols_loc - me * n_local
        in_shard = (local0 >= 0) & (local0 < n_local)
        g0 = jnp.take(x_loc, jnp.clip(local0, 0, n_local - 1), axis=0)
        y = jnp.sum(jnp.where(in_shard, data_loc * g0, 0), axis=1)
        # Boundary fix-up: only the first/last ``halo`` rows can reference
        # neighbour entries (bandwidth bound), recompute them extended.
        x_ext = jnp.concatenate([left_halo, x_loc, right_halo])
        y = y.at[:halo].set(
            ext_rows(data_loc[:halo], cols_loc[:halo], x_ext))
        y = y.at[n_local - halo:].set(
            ext_rows(data_loc[n_local - halo:], cols_loc[n_local - halo:],
                     x_ext))
        return y

    return mv(op.data, op.cols, x)


def bsr_matvec_halo(op, x, mesh, axis_name="rows", halo_blocks=None,
                    overlap=True):
    """Distributed BSR matvec with ring halo exchange, in units of block
    rows/columns (the scattered-sparsity path: dense r x c blocks, halo
    comms by ``ppermute``)."""
    from ..linop import BsrOperator

    assert isinstance(op, BsrOperator)
    r, c = op.blockshape
    assert r == c, "halo BSR assumes square blocks (row/col grids align)"
    if halo_blocks is None:
        halo_blocks = sparsity_bandwidth(op)
    nb = op.blocks.shape[0]
    n_dev = int(mesh.devices.size)
    assert nb % n_dev == 0, "pad the block grid to the mesh first"
    nb_local = nb // n_dev
    assert op.shape[0] == op.shape[1] == nb * r, (
        "halo BSR requires the padded square block grid "
        "(use pad_operator to a multiple of block*mesh)")
    assert halo_blocks <= nb_local, (
        f"block halo {halo_blocks} exceeds shard block rows {nb_local}")
    _PREC = jax.lax.Precision.HIGHEST

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None, None, None), P(axis_name, None),
                  P(axis_name)),
        out_specs=P(axis_name),
    )
    def mv(blocks_loc, bcols_loc, x_loc):
        d = lax.axis_size(axis_name)
        me = lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % d) for i in range(d)]
        bwd = [(i, (i - 1) % d) for i in range(d)]
        xb = x_loc.reshape(nb_local, c)
        h = halo_blocks
        right_halo = lax.ppermute(xb[:h], axis_name, bwd)
        # explicit start: h == 0 must give an empty window (see banded)
        left_halo = lax.ppermute(xb[nb_local - h:], axis_name, fwd)

        def ext_rows(blocks_r, bcols_r, xb_ext):
            local = jnp.clip(bcols_r - me * nb_local + h,
                             0, xb_ext.shape[0] - 1)
            gathered = jnp.take(xb_ext, local, axis=0)  # (rows, L, c)
            return jnp.einsum("blrc,blc->br", blocks_r, gathered,
                              precision=_PREC)

        if not overlap:
            xb_ext = jnp.concatenate([left_halo, xb, right_halo], axis=0)
            return ext_rows(blocks_loc, bcols_loc, xb_ext).reshape(-1)

        # Interior pass from the local block rows only (out-of-shard block
        # columns masked) — overlaps the ring permutes.
        local0 = bcols_loc - me * nb_local
        in_shard = (local0 >= 0) & (local0 < nb_local)
        g0 = jnp.take(xb, jnp.clip(local0, 0, nb_local - 1), axis=0)
        g0 = jnp.where(in_shard[:, :, None], g0, 0)
        yb = jnp.einsum("blrc,blc->br", blocks_loc, g0, precision=_PREC)
        # Boundary fix-up (first/last ``h`` block rows) on halo arrival.
        xb_ext = jnp.concatenate([left_halo, xb, right_halo], axis=0)
        yb = yb.at[:h].set(ext_rows(blocks_loc[:h], bcols_loc[:h], xb_ext))
        yb = yb.at[nb_local - h:].set(
            ext_rows(blocks_loc[nb_local - h:], bcols_loc[nb_local - h:],
                     xb_ext))
        return yb.reshape(-1)

    return mv(op.blocks, op.block_cols, x)


def _dw_halo_exchange(x_loc_pairs, halo, axis_name):
    """Ring-exchange the halo windows of each (hi, lo) limb array; returns
    the concatenated extended windows.  ``x_loc_pairs`` is a list of
    per-limb local arrays (1-D or (rows, c) blocked)."""
    d = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % d) for i in range(d)]
    bwd = [(i, (i - 1) % d) for i in range(d)]
    out = []
    for x_loc in x_loc_pairs:
        right = lax.ppermute(x_loc[:halo], axis_name, bwd)
        # explicit start: halo == 0 must give an empty window (see banded)
        left = lax.ppermute(x_loc[x_loc.shape[0] - halo:], axis_name, fwd)
        out.append(jnp.concatenate([left, x_loc, right], axis=0))
    return out


def banded_matvec_halo_dw(op, xh, xl, mesh, axis_name="rows", op_lo=None):
    """Double-word distributed banded matvec: the halo-exchange mirror of
    :func:`arnoldi_jax.ops.df32_linop.banded_matvec_dw` — error-free
    products and compensated accumulation on each shard, ring ``ppermute``
    halos for BOTH limbs (4 sends), no all-gather.  ``op_lo`` (the
    ``A - f32(A)`` cast residual, same offsets/sharding) rides the same
    extended windows."""
    from ..ops.df32 import fast_two_sum, two_prod, two_sum

    offsets = op.offsets
    halo = int(max((abs(int(o)) for o in offsets), default=0))
    n = op.shape[0]
    n_dev = int(mesh.devices.size)
    assert n % n_dev == 0, "shard rows first (pad_operator)"
    n_local = n // n_dev
    assert halo <= n_local, f"halo {halo} exceeds shard size {n_local}"
    bands_lo = None
    if op_lo is not None:
        assert isinstance(op_lo, BandedOperator) and (
            op_lo.offsets == op.offsets
            and op_lo.bands.shape == op.bands.shape), (
            "op_lo must share the operator's banded layout "
            "(build_cast_residual_operator guarantees this)")
        bands_lo = op_lo.bands

    specs = [P(None, axis_name), P(axis_name), P(axis_name)]
    args = [op.bands, xh, xl]
    if bands_lo is not None:
        specs.insert(1, P(None, axis_name))
        args.insert(1, bands_lo)

    @partial(shard_map, mesh=mesh, in_specs=tuple(specs),
             out_specs=(P(axis_name), P(axis_name)))
    def mv(*a):
        if bands_lo is not None:
            bands_loc, bands_lo_loc, xh_loc, xl_loc = a
        else:
            (bands_loc, xh_loc, xl_loc), bands_lo_loc = a, None
        xh_ext, xl_ext = _dw_halo_exchange([xh_loc, xl_loc], halo,
                                           axis_name)
        yh = jnp.zeros(n_local, jnp.float32)
        yl = jnp.zeros(n_local, jnp.float32)
        for k, off in enumerate(offsets):
            b = bands_loc[k]
            sh = lax.dynamic_slice_in_dim(xh_ext, halo + off, n_local)
            sl = lax.dynamic_slice_in_dim(xl_ext, halo + off, n_local)
            ph, pl = two_prod(b, sh)
            pl = pl + b * sl
            if bands_lo_loc is not None:
                pl = pl + bands_lo_loc[k] * sh
            s, e = two_sum(yh, ph)
            yh, yl = s, yl + pl + e
        return fast_two_sum(yh, yl)

    return mv(*args)


def ell_matvec_halo_dw(op, xh, xl, mesh, axis_name="rows", halo=None,
                       op_lo=None):
    """Double-word distributed ELL matvec with ring halo exchange (the dw
    mirror of :func:`ell_matvec_halo`)."""
    from ..linop import EllOperator
    from ..ops.df32 import dw_sum, two_prod

    assert isinstance(op, EllOperator)
    if halo is None:
        halo = sparsity_bandwidth(op)
    n = op.shape[0]
    n_dev = int(mesh.devices.size)
    assert n % n_dev == 0, "shard rows first (pad_operator)"
    n_local = n // n_dev
    assert halo <= n_local, f"halo {halo} exceeds shard size {n_local}"
    data_lo = None
    if op_lo is not None:
        assert isinstance(op_lo, EllOperator) and (
            op_lo.data.shape == op.data.shape), "op_lo layout mismatch"
        data_lo = op_lo.data

    specs = [P(axis_name, None), P(axis_name, None), P(axis_name),
             P(axis_name)]
    args = [op.data, op.cols, xh, xl]
    if data_lo is not None:
        specs.insert(1, P(axis_name, None))
        args.insert(1, data_lo)

    @partial(shard_map, mesh=mesh, in_specs=tuple(specs),
             out_specs=(P(axis_name), P(axis_name)))
    def mv(*a):
        if data_lo is not None:
            data_loc, data_lo_loc, cols_loc, xh_loc, xl_loc = a
        else:
            (data_loc, cols_loc, xh_loc, xl_loc), data_lo_loc = a, None
        me = lax.axis_index(axis_name)
        xh_ext, xl_ext = _dw_halo_exchange([xh_loc, xl_loc], halo,
                                           axis_name)
        local = jnp.clip(cols_loc - me * n_local + halo,
                         0, xh_ext.shape[0] - 1)
        gh = jnp.take(xh_ext, local, axis=0)
        gl = jnp.take(xl_ext, local, axis=0)
        ph, pl = two_prod(data_loc, gh)
        pl = pl + data_loc * gl
        if data_lo_loc is not None:
            pl = pl + data_lo_loc * gh
        return dw_sum(ph, pl, axis=1)

    return mv(*args)


def bsr_matvec_halo_dw(op, xh, xl, mesh, axis_name="rows",
                       halo_blocks=None, op_lo=None):
    """Double-word distributed BSR matvec with block-granular ring halo
    exchange (the dw mirror of :func:`bsr_matvec_halo`; dense r x c blocks,
    compensated accumulation over the slot axis)."""
    from ..linop import BsrOperator
    from ..ops.df32 import dw_sum, fast_two_sum, two_prod, two_sum

    assert isinstance(op, BsrOperator)
    r, c = op.blockshape
    assert r == c, "halo BSR assumes square blocks"
    if halo_blocks is None:
        halo_blocks = sparsity_bandwidth(op)
    nb, L = op.block_cols.shape
    n_dev = int(mesh.devices.size)
    assert nb % n_dev == 0, "pad the block grid to the mesh first"
    nb_local = nb // n_dev
    assert op.shape[0] == op.shape[1] == nb * r
    assert halo_blocks <= nb_local
    blocks_lo = None
    if op_lo is not None:
        assert isinstance(op_lo, BsrOperator) and (
            op_lo.blocks.shape == op.blocks.shape), "op_lo layout mismatch"
        blocks_lo = op_lo.blocks
    h = halo_blocks

    specs = [P(axis_name, None, None, None), P(axis_name, None),
             P(axis_name), P(axis_name)]
    args = [op.blocks, op.block_cols, xh, xl]
    if blocks_lo is not None:
        specs.insert(1, P(axis_name, None, None, None))
        args.insert(1, blocks_lo)

    @partial(shard_map, mesh=mesh, in_specs=tuple(specs),
             out_specs=(P(axis_name), P(axis_name)))
    def mv(*a):
        if blocks_lo is not None:
            blocks_loc, blocks_lo_loc, bcols_loc, xh_loc, xl_loc = a
        else:
            (blocks_loc, bcols_loc, xh_loc, xl_loc), blocks_lo_loc = a, None
        me = lax.axis_index(axis_name)
        xbh = xh_loc.reshape(nb_local, c)
        xbl = xl_loc.reshape(nb_local, c)
        xbh_ext, xbl_ext = _dw_halo_exchange([xbh, xbl], h, axis_name)
        local = jnp.clip(bcols_loc - me * nb_local + h,
                         0, xbh_ext.shape[0] - 1)
        yh = jnp.zeros((nb_local, r), jnp.float32)
        yl = jnp.zeros((nb_local, r), jnp.float32)
        # Static loop over the small slot axis bounds temporaries at
        # (nb_local, r, c) — same shape discipline as bsr_matvec_dw.
        for l in range(L):
            gh = jnp.take(xbh_ext, local[:, l], axis=0)   # (nb_loc, c)
            gl = jnp.take(xbl_ext, local[:, l], axis=0)
            B = blocks_loc[:, l]                           # (nb_loc, r, c)
            ph, pl = two_prod(B, gh[:, None, :])
            pl = pl + B * gl[:, None, :]
            if blocks_lo_loc is not None:
                pl = pl + blocks_lo_loc[:, l] * gh[:, None, :]
            sh, sl = dw_sum(ph, pl, axis=-1)               # (nb_loc, r)
            s, e = two_sum(yh, sh)
            yh, yl = s, yl + sl + e
        yh, yl = fast_two_sum(yh, yl)
        return yh.reshape(-1), yl.reshape(-1)

    return mv(*args)


from ..linop import CallableOperator as _CallableOperator


@jax.tree_util.register_pytree_node_class
class HaloOperator(_CallableOperator):
    """Operator wrapper for the ring-halo distributed matvec.

    A PYTREE whose children are the underlying format operator (and the
    optional cast-residual companion): the sharded band/block arrays enter
    every jit as ARGUMENTS.  The previous CallableOperator closure held
    them as trace-time constants, which works single-process but is
    rejected on a multi-process mesh ("closing over jax.Array that spans
    non-addressable devices") — caught by tests/test_multihost_spawn.py,
    and exactly what a real pod would hit.

    ``matvec_dw`` carries the DOUBLE-WORD halo matvec, so
    ``partial_schur(..., refine=...)`` runs the 1e-8 dw continuation over
    the same ring comms; pass ``op_lo`` (the sharded cast-residual
    operator, same format/layout) to make the refinement target the
    original f64 matrix rather than its f32 cast.
    """

    def __init__(self, op, mesh, axis_name, op_lo, halo, shape, dtype, nnz):
        self.op = op
        self.op_lo = op_lo
        self.mesh = mesh
        self.axis_name = axis_name
        self._halo = halo
        # CallableOperator surface (isinstance passthrough in as_operator,
        # the solvers' fn/fn_dw checks) with bound-method callables.
        super().__init__(self.matvec, shape, dtype, nnz=nnz,
                         fn_dw=self.matvec_dw)

    def matvec(self, x):
        from ..linop import BsrOperator, EllOperator

        if isinstance(self.op, BandedOperator):
            return banded_matvec_halo(self.op, x, self.mesh, self.axis_name)
        if isinstance(self.op, EllOperator):
            return ell_matvec_halo(self.op, x, self.mesh, self.axis_name,
                                   self._halo)
        assert isinstance(self.op, BsrOperator)
        return bsr_matvec_halo(self.op, x, self.mesh, self.axis_name,
                               self._halo)

    def matvec_dw(self, xh, xl):
        from ..linop import BsrOperator, EllOperator

        if isinstance(self.op, BandedOperator):
            return banded_matvec_halo_dw(self.op, xh, xl, self.mesh,
                                         self.axis_name, op_lo=self.op_lo)
        if isinstance(self.op, EllOperator):
            return ell_matvec_halo_dw(self.op, xh, xl, self.mesh,
                                      self.axis_name, self._halo,
                                      op_lo=self.op_lo)
        assert isinstance(self.op, BsrOperator)
        return bsr_matvec_halo_dw(self.op, xh, xl, self.mesh,
                                  self.axis_name, self._halo,
                                  op_lo=self.op_lo)

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def tree_flatten(self):
        return (self.op, self.op_lo), (self.mesh, self.axis_name,
                                       self._halo, self._shape, self._dtype,
                                       self._nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], children[1], aux[2],
                   aux[3], aux[4], aux[5])


def halo_matvec_closure(op, mesh, axis_name="rows", op_lo=None):
    """Build the :class:`HaloOperator` for ``op`` (name kept from the
    closure-based original).  Dispatches on operator type; raises for
    formats without a halo path (fall back to the GSPMD gather there)."""
    from ..linop import BsrOperator, EllOperator

    if isinstance(op, BandedOperator):
        halo = None          # derived from op.offsets inside the kernels
    elif isinstance(op, (EllOperator, BsrOperator)):
        halo = sparsity_bandwidth(op)   # host index scan: done ONCE here,
        # never during tree_unflatten (children may be tracers there)
    else:
        raise TypeError(
            f"no halo path for {type(op).__name__}; use the GSPMD gather")
    return HaloOperator(op, mesh, axis_name, op_lo, halo, op.shape,
                        op.dtype, op.nnz)
