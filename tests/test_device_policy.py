"""Device-independent policy: float32 products at full precision, the
compile-cache placement, the bandwidth-peak table, the work-dtype rule and
paths that must behave the same whatever backend JAX reports."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from arnoldi_jax.linop import (BandedOperator, BsrOperator, EllOperator,
                               as_operator)
from arnoldi_jax.matrices import laplace_2d, laplace_2d_eigen, mark
from arnoldi_jax.utils import compile_cache


def _lowered_expand(op, m, b):
    from arnoldi_jax.solvers.decomposition import (_block_expand_jit,
                                                   _expand_jit)

    n = op.shape[0]
    V = jnp.zeros((m + b, n), jnp.float32)
    H = jnp.zeros((m + b, m), jnp.float32)
    tol = jnp.float32(1e-4)
    if b == 1:
        return _expand_jit.lower(op, V, H, tol, start_dim=0, max_dim=m,
                                 ortho="cgs2")
    return _block_expand_jit.lower(op, V, H, tol, start_block=0,
                                   n_blocks=m // b, b=b)


def _lowered_truncate_and_expand(op, m, b):
    from arnoldi_jax.solvers.krylov_schur import _truncate_and_expand

    n = op.shape[0]
    p = m // 2
    return _truncate_and_expand.lower(
        op, jnp.zeros((m + 1, n), jnp.float32), jnp.zeros((m, p), jnp.float32),
        jnp.zeros((m + 1, m), jnp.float32), jnp.float32(1e-4), p=p, m=m,
        max_dim=m, ortho="cgs2")


@pytest.mark.parametrize("lower,b", [
    (_lowered_expand, 1),
    (_lowered_expand, 4),
    (_lowered_truncate_and_expand, 1),
], ids=["expand", "block_expand", "truncate_and_expand"])
def test_float32_products_request_highest(lower, b):
    """A default-precision float32 product may run in TF32 on the GPU:
    every dot_general on the solve path must ask for HIGHEST."""
    op = as_operator(mark(10).astype(np.float32), format="ell")
    txt = lower(op, 8, b).as_text()
    dots = [ln for ln in txt.splitlines() if "stablehlo.dot_general" in ln]
    assert dots
    for ln in dots:
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", ln), ln


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; nothing here sets another directory.
    assert "jax_compilation_cache_dir" not in dict(calls)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, tmp_path):
    import os

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "c"))
    assert compile_cache.enable() == str(tmp_path / "c")
    assert dict(calls)["jax_compilation_cache_dir"] == str(tmp_path / "c")
    assert os.path.isdir(tmp_path / "c")


def test_compile_cache_default_path():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")


def test_peak_table_has_h100():
    assert bench.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12


def test_peak_table_unknown_device_raises():
    with pytest.raises(KeyError, match="no bandwidth peak"):
        bench.hbm_peak("cpu")
    with pytest.raises(KeyError):
        bench.roofline_fraction(1e-3, 100, 500, 10, 1, 8, "Some Accelerator v1")


def test_roofline_fraction_model():
    # 4 passes over (m+1)/2 rows of n, plus nnz + 2n, in 8-byte words.
    n, nnz, m = 1000, 5000, 9
    bytes_ = (4 * 0.5 * (m + 1) * n + nnz + 2 * n) * 8
    frac = bench.roofline_fraction(1.0, n, nnz, m, 1, 8,
                                   "NVIDIA H100 80GB HBM3")
    assert frac == pytest.approx(bytes_ / 3.35e12)


@pytest.fixture(params=["gpu", "cpu"])
def backend(request, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


def test_format_choice_same_on_every_backend(backend):
    from arnoldi_jax.matrices import random_scattered

    assert isinstance(as_operator(laplace_2d(16)), BandedOperator)
    tiles = random_scattered(1 << 10, 24, seed=1, bandwidth=16, block=8)
    assert isinstance(as_operator(tiles), BsrOperator)
    scalar = random_scattered(1 << 10, 24, seed=1, bandwidth=64)
    assert isinstance(as_operator(scalar), EllOperator)
    assert isinstance(as_operator(mark(20)), EllOperator)
    assert isinstance(as_operator(tiles, format="ell"), EllOperator)


def test_splu_shift_invert_on_every_backend(backend):
    from arnoldi_jax import eigsh

    g = 12
    vals, _ = eigsh(laplace_2d(g), 3, sigma=-7.9, inner_solver="splu",
                    tol=1e-10)
    ev = laplace_2d_eigen(g)
    err = np.abs(np.asarray(vals)[:, None] - ev[None, :]).min(axis=1)
    assert err.max() < 1e-8


def test_scipy_linear_operator_on_every_backend(backend):
    from scipy.sparse.linalg import aslinearoperator, eigs

    from arnoldi_jax import partial_schur

    A = mark(12)
    _, T, _ = partial_schur(as_operator(aslinearoperator(A)), 3,
                            sort_function="LR", stopping_criterion=1e-10,
                            max_restarts=500)
    got = np.sort(np.linalg.eigvals(np.asarray(T)).real)
    want = np.sort(eigs(A, 3, which="LR")[0].real)
    np.testing.assert_allclose(got, want, atol=1e-8)


def test_solver_dtype_keeps_real_f32_with_x64_off():
    from arnoldi_jax.solvers.krylov_schur import _solver_dtype

    with jax.enable_x64(False):
        assert _solver_dtype(np.float32, None) == np.float32
        assert _solver_dtype(np.float64, None) == np.float32
        assert _solver_dtype(np.complex64, None) == np.complex64
        assert _solver_dtype(np.float32, np.complex64) == np.complex64


def test_solver_dtype_unchanged_with_x64_on():
    from arnoldi_jax.solvers.krylov_schur import _solver_dtype

    assert _solver_dtype(np.float64, None) == np.complex128
    assert _solver_dtype(np.float32, None) == np.complex64
    assert _solver_dtype(np.float64, np.float32) == np.float32


def test_x64_off_real_path_reaches_1e8():
    """A real operator with 64-bit types off runs real float32 and the
    double-word continuation, reaching a 1e-8 residual (complex64 would
    stall near 1e-6)."""
    from arnoldi_jax import partial_schur

    A = mark(15)
    with jax.enable_x64(False):
        Q, T, _ = partial_schur(A, 3, sort_function="LR",
                                stopping_criterion=1e-8, max_restarts=2000)
    assert np.asarray(T).dtype == np.float64      # refined on the host
    res = np.linalg.norm(A @ Q - Q @ T, axis=0)
    assert res.max() < 1e-8 * np.abs(np.linalg.eigvals(T)).max()


def test_scaling_bench_labels_platform():
    from arnoldi_jax.harness.scaling_bench import run_scaling

    rows = run_scaling(n_grid=16, device_counts=(1,), max_dim=8, cycles=1)
    assert rows[0]["backend"] == "cpu"
    assert rows[0]["device_kind"] == jax.devices()[0].device_kind
    assert "virtual-device" in rows[0]["measurement"]


def test_dryrun_multichip_refuses_missing_devices():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="need 64 cpu devices"):
        __graft_entry__.dryrun_multichip(64)


def test_eigenpairs_real_basis_complex_vectors():
    """Complex eigenvectors of a real Schur form from a real device basis:
    one real matmul against [Re S | Im S]."""
    from arnoldi_jax import eigenpairs_from_partial_schur

    A = np.array([[0.0, -2.0, 0.3], [2.0, 0.0, 0.1], [0.0, 0.0, 0.5]])
    Q = jnp.asarray(np.eye(3))
    vals, vecs = eigenpairs_from_partial_schur(Q, A)
    vecs = np.asarray(vecs)
    np.testing.assert_allclose(A @ vecs, vecs * vals[None, :], atol=1e-12)
    assert np.iscomplexobj(vecs)
