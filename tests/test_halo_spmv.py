"""Halo-exchange SpMV tests on the 8-virtual-device mesh: ring ppermute
halos must reproduce the dense matvec exactly, including at the global
boundary rows (where zero band entries neutralize the ring wrap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from arnoldi_jax.linop import as_operator
from arnoldi_jax.matrices import laplace, laplace_2d
from arnoldi_jax.parallel import (
    banded_matvec_halo,
    halo_matvec_closure,
    make_mesh,
    shard_operator,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _sharded_x(mesh, n, seed=0):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(n))
    return jax.device_put(x, NamedSharding(mesh, P("rows")))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("gen,n", [
    (lambda: laplace(1024).tocsr(), 1024),
    (lambda: laplace_2d(32), 1024),
    (lambda: laplace_2d(16, 32), 512),
])
def test_matches_dense(gen, n, mesh, overlap):
    op = as_operator(gen())
    sop = shard_operator(op, mesh)
    x = _sharded_x(mesh, n)
    y = banded_matvec_halo(sop, x, mesh, overlap=overlap)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(op.matvec(x)), atol=1e-12
    )
    assert len(y.sharding.device_set) == 8


@pytest.mark.parametrize("overlap", [False, True])
def test_zero_halo_diagonal(mesh, overlap):
    # halo == 0 (purely diagonal stored sparsity) regression: the
    # x_loc[-halo:] idiom selected the WHOLE shard, so every shard's
    # extended window was the left neighbour's values shifted by n_local
    # (measured error ~1e2 on a diagonal operator).  All four halo
    # kernels (banded/ell/bsr, f32 and dw) must treat 0 as "no exchange".
    import scipy.sparse as sp

    from arnoldi_jax.parallel import bsr_matvec_halo, ell_matvec_halo

    n = 512
    d = np.linspace(1.0, 2.0, n)
    D = sp.diags(d).tocsr()
    x = _sharded_x(mesh, n, seed=7)
    want = d * np.asarray(x)

    bop = shard_operator(as_operator(D, format="banded"), mesh)
    np.testing.assert_allclose(
        np.asarray(banded_matvec_halo(bop, x, mesh, overlap=overlap)),
        want, atol=1e-12)
    eop = shard_operator(as_operator(D, format="ell"), mesh)
    np.testing.assert_allclose(
        np.asarray(ell_matvec_halo(eop, x, mesh, overlap=overlap)),
        want, atol=1e-12)
    sbop = shard_operator(as_operator(D, format=("bsr", (8, 8))), mesh)
    np.testing.assert_allclose(
        np.asarray(bsr_matvec_halo(sbop, x, mesh, overlap=overlap)),
        want, atol=1e-12)


def test_zero_halo_dw(mesh):
    import scipy.sparse as sp

    from arnoldi_jax.parallel import banded_matvec_halo_dw

    n = 512
    d = np.linspace(1.0, 2.0, n)
    bop = shard_operator(
        as_operator(sp.diags(d).tocsr(), format="banded",
                    dtype=np.float32), mesh)
    x = _sharded_x(mesh, n, seed=8)
    xh = jax.device_put(jnp.asarray(np.asarray(x), jnp.float32),
                        NamedSharding(mesh, P("rows")))
    xl = jnp.zeros_like(xh)
    yh, yl = banded_matvec_halo_dw(bop, xh, xl, mesh)
    got = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    np.testing.assert_allclose(got, d * np.asarray(xh, np.float64),
                               rtol=1e-6)


def test_halo_too_large_raises(mesh):
    op = as_operator(laplace_2d(16))  # n=256, halo=16, n_local=32 fine
    sop = shard_operator(op, mesh)
    # fabricate a huge offset
    import dataclasses

    bad = dataclasses.replace(sop, offsets=(0, 200, -200))
    with pytest.raises(AssertionError, match="halo"):
        banded_matvec_halo(bad, _sharded_x(mesh, 256), mesh)


def test_closure_in_solver(mesh):
    # Use the halo matvec as the operator inside the sharded Lanczos solve.
    from arnoldi_jax.solvers.lanczos import partial_eigh
    from arnoldi_jax.matrices import laplace_eigen

    n = 1024
    op = as_operator(laplace(n).tocsr())
    sop = shard_operator(op, mesh)
    hop = halo_matvec_closure(sop, mesh)

    vals, vecs, _ = partial_eigh(
        hop, 3, which="LA", stopping_criterion=1e-9, max_restarts=3000,
        mesh=mesh, key=jax.random.key(2),
    )
    want = np.sort(laplace_eigen(n))[::-1][:3]
    np.testing.assert_allclose(np.sort(vals)[::-1], want, rtol=1e-8,
                               atol=1e-9)


class TestScatteredHalo:
    """ELL/BSR halo paths (general scattered sparsity, VERDICT round-1
    item 3): ring ppermute + local index remap must reproduce the
    single-device matvec with NO all-gather in the compiled HLO."""

    def _mark_ops(self, n_pad=512):
        from arnoldi_jax.linop import pad_operator
        from arnoldi_jax.matrices import mark

        A = mark(31)  # n=496, bandwidth ~33
        ell = pad_operator(as_operator(A, format="ell"), n_pad)
        bsr = pad_operator(as_operator(A, format=("bsr", (8, 8))), n_pad)
        return A, ell, bsr

    @pytest.mark.parametrize("overlap", [False, True])
    def test_ell_matches_single_device(self, mesh, overlap):
        from arnoldi_jax.parallel import ell_matvec_halo

        A, ell, _ = self._mark_ops()
        sop = shard_operator(ell, mesh)
        x = _sharded_x(mesh, 512, seed=3)
        y = ell_matvec_halo(sop, x, mesh, overlap=overlap)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ell.matvec(x)),
                                   atol=1e-12)

    @pytest.mark.parametrize("overlap", [False, True])
    def test_bsr_matches_single_device(self, mesh, overlap):
        from arnoldi_jax.parallel import bsr_matvec_halo

        A, _, bsr = self._mark_ops()
        sop = shard_operator(bsr, mesh)
        x = _sharded_x(mesh, 512, seed=4)
        y = bsr_matvec_halo(sop, x, mesh, overlap=overlap)
        np.testing.assert_allclose(np.asarray(y), np.asarray(bsr.matvec(x)),
                                   atol=1e-12)

    def test_overlap_interior_independent_of_permute(self, mesh):
        # Structural overlap property: in the overlapped lowering the BIG
        # contraction (interior einsum over all local block rows) must not
        # data-depend on the ppermute results, so the scheduler is FREE to
        # run it while the collective is in flight.  Verify on the jaxpr:
        # every dot_general whose operand shapes match the interior pass
        # appears before the first use of a ppermute output ... simplest
        # robust proxy: the closed jaxpr printed form must contain a
        # dot_general BEFORE the first concatenate of the halo buffers.
        from arnoldi_jax.parallel import bsr_matvec_halo

        _, _, bsr = self._mark_ops()
        sop = shard_operator(bsr, mesh)
        x = _sharded_x(mesh, 512, seed=5)
        jaxpr = str(jax.make_jaxpr(
            lambda xx: bsr_matvec_halo(sop, xx, mesh, overlap=True))(x))
        first_dot = jaxpr.index("dot_general")
        first_concat = jaxpr.index("concatenate")
        assert first_dot < first_concat, (
            "interior contraction should be emitted before the halo "
            "concatenate (no dependency on the collective)")
        # and the non-overlapped form has the opposite structure
        jaxpr0 = str(jax.make_jaxpr(
            lambda xx: bsr_matvec_halo(sop, xx, mesh, overlap=False))(x))
        assert jaxpr0.index("concatenate") < jaxpr0.index("dot_general")

    def test_compiled_hlo_has_no_all_gather(self, mesh):
        # The VERDICT "no-all-gather proof": compile the sharded halo
        # matvec AND a full Arnoldi expansion step over it; the optimized
        # HLO must use collective-permute (ring halo) and all-reduce
        # (psum'd dot products) but NEVER all-gather.
        from jax.sharding import NamedSharding
        from arnoldi_jax.parallel import halo_matvec_closure
        from arnoldi_jax.solvers.decomposition import _expand_jit

        _, _, bsr = self._mark_ops()
        sop = shard_operator(bsr, mesh)
        hop = halo_matvec_closure(sop, mesh)
        x = _sharded_x(mesh, 512, seed=5)

        txt = jax.jit(hop.matvec).lower(x).compile().as_text()
        assert "all-gather" not in txt, "halo matvec fell back to all-gather"
        assert "collective-permute" in txt, "expected ring halo comms"

        m = 12
        Vt = jax.device_put(jnp.zeros((m + 1, 512)),
                            NamedSharding(mesh, P(None, "rows")))
        H = jax.device_put(jnp.zeros((m + 1, m)),
                           NamedSharding(mesh, P(None, None)))
        lowered = jax.jit(
            lambda V, H: _expand_jit(hop, V, H, jnp.asarray(1e-12),
                                     start_dim=0, max_dim=m, ortho="cgs2")
        ).lower(Vt, H)
        txt2 = lowered.compile().as_text()
        assert "all-gather" not in txt2, (
            "sharded Arnoldi expansion contains an all-gather")
        assert "collective-permute" in txt2
        assert "all-reduce" in txt2  # the psum'd Gram-Schmidt projections

    def test_ell_halo_solver_end_to_end(self, mesh):
        # Full sharded Krylov-Schur over the ELL halo closure matches the
        # single-device solve.
        from arnoldi_jax import partial_schur
        from arnoldi_jax.parallel import halo_matvec_closure
        from arnoldi_jax.matrices import mark
        from arnoldi_jax.utils.sorting import arg_largest_real

        A, ell, _ = self._mark_ops()
        sop = shard_operator(ell, mesh)
        hop = halo_matvec_closure(sop, mesh)
        Q, T, _ = partial_schur(
            hop, 3, max_dim=16, stopping_criterion=1e-9,
            sort_function=arg_largest_real, max_restarts=3000,
            mesh=mesh, key=jax.random.key(7))
        Qh, Th = np.asarray(Q)[:496], np.asarray(T)
        res = np.linalg.norm(A.todense() @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-7)


class TestDwHalo:
    """Double-word halo matvecs: the refinement tier's distributed SpMV
    (ring ppermute for both limbs, compensated per-shard accumulation)."""

    def _dw_x(self, n, seed):
        from arnoldi_jax.ops.df32 import dw_from_f64

        x = np.random.default_rng(seed).standard_normal(n)
        xh, xl = dw_from_f64(x)
        return x, jnp.asarray(xh), jnp.asarray(xl)

    @pytest.mark.parametrize("fmt", ["banded", "ell", "bsr"])
    def test_matches_single_device_dw(self, mesh, fmt):
        from arnoldi_jax.linop import pad_operator
        from arnoldi_jax.matrices import mark
        from arnoldi_jax.ops.df32 import dw_to_f64
        from arnoldi_jax.ops.df32_linop import dw_matvec
        from arnoldi_jax.parallel import (banded_matvec_halo_dw,
                                          bsr_matvec_halo_dw,
                                          ell_matvec_halo_dw,
                                          shard_operator)
        from arnoldi_jax.solvers.refine import (
            build_cast_residual_operator, cast_operator_f32)

        A = (laplace(512).tocsr() if fmt == "banded"
             else mark(31))  # mark: n=496 -> pad 512
        spec = {"banded": "banded", "ell": "ell", "bsr": ("bsr", (8, 8))}
        op64 = pad_operator(as_operator(A, format=spec[fmt]), 512)
        op32 = cast_operator_f32(op64)
        op_lo = build_cast_residual_operator(A, op32)  # may be None
        if op_lo is not None:
            from arnoldi_jax.linop import pad_operator as _pad

            op_lo = _pad(op_lo, 512)
        sop = shard_operator(op32, mesh)
        slo = shard_operator(op_lo, mesh) if op_lo is not None else None
        x, xh, xl = self._dw_x(512, seed=11)

        kern = {"banded": banded_matvec_halo_dw, "ell": ell_matvec_halo_dw,
                "bsr": bsr_matvec_halo_dw}[fmt]
        yh, yl = kern(sop, jax.device_put(xh, _rows(mesh)),
                      jax.device_put(xl, _rows(mesh)), mesh, op_lo=slo)
        got = dw_to_f64(np.asarray(yh), np.asarray(yl))
        # reference: single-device dw matvec of the same operator pair
        ryh, ryl = dw_matvec(op32, xh, xl, op_lo=op_lo)
        want = dw_to_f64(np.asarray(ryh), np.asarray(ryl))
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, atol=5e-13 * scale)

    def test_closure_refine_end_to_end_1e8(self, mesh):
        # Full sharded Krylov-Schur + dw refinement over the BSR halo
        # closure: 1e-8 residuals against the TRUE f64 matrix with ring
        # comms only.
        from arnoldi_jax import partial_schur
        from arnoldi_jax.linop import pad_operator
        from arnoldi_jax.matrices import mark
        from arnoldi_jax.parallel import halo_matvec_closure, shard_operator
        from arnoldi_jax.solvers.refine import (
            build_cast_residual_operator, cast_operator_f32)
        from arnoldi_jax.utils.sorting import arg_largest_real

        A = mark(31)
        op64 = pad_operator(as_operator(A, format=("bsr", (8, 8))), 512)
        op32 = cast_operator_f32(op64)
        op_lo = pad_operator(
            build_cast_residual_operator(A, op32), 512)
        sop = shard_operator(op32, mesh)
        slo = shard_operator(op_lo, mesh)
        hop = halo_matvec_closure(sop, mesh, op_lo=slo)
        Q, T, hist = partial_schur(
            hop, 3, mesh=mesh, max_dim=20, stopping_criterion=1e-8,
            sort_function=arg_largest_real, max_restarts=3000,
            dtype=np.float32, ortho="cgs2", key=jax.random.key(9))
        Qh = Q[:496]
        res = np.linalg.norm(A.todense() @ Qh - Qh @ np.asarray(T), axis=0)
        assert res.max() < 1e-8, res.max()

    def test_dw_expand_hlo_no_all_gather(self, mesh):
        # The no-all-gather proof for the REFINEMENT tier: the dw Arnoldi
        # expansion over the halo closure must compile to ring
        # collective-permutes + all-reduces only.
        from arnoldi_jax.linop import pad_operator
        from arnoldi_jax.matrices import mark
        from arnoldi_jax.parallel import halo_matvec_closure, shard_operator
        from arnoldi_jax.parallel.sharded import shard_workspace
        from arnoldi_jax.solvers.refine import (_dw_expand_impl,
                                                cast_operator_f32)

        A = mark(31)
        op32 = cast_operator_f32(pad_operator(
            as_operator(A.astype(np.float32), format=("bsr", (8, 8))), 512))
        sop = shard_operator(op32, mesh)
        hop = halo_matvec_closure(sop, mesh)
        m = 8
        Vh = jnp.zeros((m + 1, 512), jnp.float32)
        Vl = jnp.zeros((m + 1, 512), jnp.float32)
        Hh = jnp.zeros((m + 1, m), jnp.float32)
        Hl = jnp.zeros((m + 1, m), jnp.float32)
        Vh, Hh = shard_workspace(Vh, Hh, mesh)
        Vl, Hl = shard_workspace(Vl, Hl, mesh)
        txt = jax.jit(
            lambda o, a, b, c, d, t: _dw_expand_impl(
                o, a, b, c, d, t, start_dim=0, max_dim=m)
        ).lower(hop, Vh, Vl, Hh, Hl,
                jnp.asarray(1e-7, jnp.float32)).compile().as_text()
        assert "all-gather" not in txt, (
            "dw expansion over the halo closure contains an all-gather")
        assert "collective-permute" in txt


def _rows(mesh):
    return NamedSharding(mesh, P("rows"))
