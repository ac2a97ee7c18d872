"""Sharded-execution tests on the 8-virtual-device CPU mesh (SURVEY §4's
prescription for testing distribution without a cluster): results must match
the single-device solve, and the big arrays must actually be partitioned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arnoldi_jax import as_operator, partial_schur
from arnoldi_jax.matrices import laplace, mark
from arnoldi_jax.parallel import (
    make_mesh,
    shard_operator,
    shard_workspace,
    sharded_partial_schur,
)
from arnoldi_jax.utils.sorting import arg_largest_real

norm = np.linalg.norm


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8


def test_shard_operator_partitions_rows(mesh):
    from arnoldi_jax.linop import pad_operator

    op = as_operator(mark(50))  # n = 1275, padded to 1280 for 8 shards
    padded = pad_operator(op, 1280)
    sop = shard_operator(padded, mesh)
    shards = sop.data.sharding
    assert len(shards.device_set) == 8
    x = jnp.ones(1280)
    got = np.asarray(sop.matvec(x))
    np.testing.assert_allclose(got[:1275], np.asarray(op.matvec(x[:1275])),
                               atol=1e-12)
    np.testing.assert_allclose(got[1275:], 0, atol=0)


def test_sharded_matvec_banded(mesh):
    op = as_operator(laplace(512))
    sop = shard_operator(op, mesh)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(512))
    np.testing.assert_allclose(
        np.asarray(sop.matvec(x)), np.asarray(op.matvec(x)), atol=1e-12
    )


def test_shard_workspace(mesh):
    Vt = jnp.zeros((21, 1280))  # transposed layout: vectors are rows
    H = jnp.zeros((21, 20))
    Vs, Hs = shard_workspace(Vt, H, mesh)
    assert len(Vs.sharding.device_set) == 8
    # H replicated
    assert Hs.sharding.is_fully_replicated


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_sharded_partial_schur_matches_single(dtype, mesh):
    A = mark(30)  # n = 465
    kwargs = dict(
        stopping_criterion=1e-9,
        sort_function=arg_largest_real,
        max_restarts=2000,
        dtype=dtype,
        key=jax.random.key(7),
    )
    Q1, T1, h1 = partial_schur(A, 3, **kwargs)
    Q2, T2, h2 = sharded_partial_schur(A, 3, mesh=mesh, **kwargs)

    # Same subspace and same Schur matrix up to tolerance: compare the
    # residuals and eigenvalues (floating reduction order may differ).
    for Q, T in [(Q1, T1), (Q2, T2)]:
        Qh, Th = np.asarray(Q), np.asarray(T)
        res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-8)
    v1 = np.sort_complex(np.linalg.eigvals(np.asarray(T1)))
    v2 = np.sort_complex(np.linalg.eigvals(np.asarray(T2)))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)

    # The returned basis must be sharded over the mesh.
    assert len(Q2.sharding.device_set) == 8


def test_sharded_float32_real_path(mesh):
    A = mark(20).astype(np.float32)
    Q, T, _ = sharded_partial_schur(
        A, 2, mesh=mesh, stopping_criterion=3e-4,
        sort_function=arg_largest_real, max_restarts=1000,
        dtype=np.float32, ortho="cgs2", key=jax.random.key(1),
    )
    Qh, Th = np.asarray(Q), np.asarray(T)
    res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=2e-3)


def test_scaling_bench_mechanism(mesh):
    # Virtual CPU devices share one core, so only the MECHANISM is under
    # test: runs per device count, reports rates and efficiencies.
    from arnoldi_jax.harness.scaling_bench import run_scaling

    results = run_scaling(n_grid=60, device_counts=(1, 2), max_dim=12,
                          cycles=1)
    assert [r["devices"] for r in results] == [1, 2]
    assert all(r["nnz_per_s"] > 0 for r in results)
    assert results[0]["efficiency"] == 1.0


def test_multihost_helpers(mesh):
    from arnoldi_jax.parallel.multihost import (
        initialize,
        make_slice_mesh,
        process_local_rows,
    )

    initialize()  # single-process: must be a no-op
    m = make_slice_mesh()
    assert m.devices.size == len(jax.devices())
    lo, hi = process_local_rows(1000, m)
    assert (lo, hi) == (0, 1000)  # single process owns everything

    # Shard-boundary agreement with the solver's padding rule (round-1
    # advisor finding): per-device ranges must come from the PADDED size.
    class FakeDev:
        def __init__(self, pid):
            self.process_index = pid
            self.id = pid

    import numpy as np
    from jax.sharding import Mesh

    # n=1000, 8 devices, BSR granularity 8: n_solve = 1024, per_dev = 128.
    fake = Mesh(np.array([FakeDev(i) for i in range(8)]), ("rows",))
    import unittest.mock as mock

    with mock.patch.object(jax, "process_index", lambda: 3):
        lo, hi = process_local_rows(1000, fake, row_granularity=8)
    assert (lo, hi) == (3 * 128, 4 * 128)
    with mock.patch.object(jax, "process_index", lambda: 7):
        lo, hi = process_local_rows(1000, fake, row_granularity=8)
    assert (lo, hi) == (7 * 128, 1000)  # clamped to n


def test_scaling_bench_scattered_halo(mesh):
    # BSR-8 halo path through the scaling mechanism (the round-1 VERDICT
    # noted the gather fallback would sink scaling; this path rings).
    from arnoldi_jax.harness.scaling_bench import run_scaling

    results = run_scaling(n_grid=32, device_counts=(1, 2), max_dim=10,
                          cycles=1, matrix="scattered")
    assert len(results) == 2
    assert all(r["nnz_per_s"] > 0 for r in results)


def test_sharded_refine_reaches_1e8(mesh):
    # The scale analog at BASELINE accuracy: f32 + dw refinement UNDER A
    # MESH (sharded limb workspaces, GSPMD-partitioned dw kernels) must
    # reach 1e-8 residuals against the true f64 matrix, matching the
    # single-device refined solve.
    A = mark(30)  # n = 465 -> padded to 472 on 8 devices
    kwargs = dict(
        stopping_criterion=1e-8, sort_function=arg_largest_real,
        max_restarts=2000, dtype=np.float32, ortho="cgs2",
        key=jax.random.key(3),
    )
    Q1, T1, h1 = partial_schur(A, 3, **kwargs)
    Q2, T2, h2 = sharded_partial_schur(A, 3, mesh=mesh, **kwargs)
    for Q, T in [(Q1, T1), (Q2, T2)]:
        assert isinstance(Q, np.ndarray) and Q.dtype == np.float64
        assert Q.shape[0] == A.shape[0]  # padding sliced off
        res = norm(A.todense() @ Q - Q @ T, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-8)
    v1 = np.sort_complex(np.linalg.eigvals(T1))
    v2 = np.sort_complex(np.linalg.eigvals(T2))
    np.testing.assert_allclose(v1, v2, rtol=1e-9, atol=1e-11)


def test_sharded_refine_banded(mesh):
    from arnoldi_jax.solvers.lanczos import partial_eigh
    from arnoldi_jax.matrices import laplace, laplace_eigen

    n = 1024
    A = laplace(n).tocsr()
    vals, vecs, _ = partial_eigh(
        A, 3, which="LA", stopping_criterion=1e-8, max_restarts=3000,
        mesh=mesh, dtype=np.float32, key=jax.random.key(5))
    want = np.sort(laplace_eigen(n))[::-1][:3]
    np.testing.assert_allclose(np.sort(np.asarray(vals))[::-1], want,
                               rtol=1e-7, atol=1e-8)
