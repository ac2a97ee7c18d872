"""Orthogonalization kernel tests: orthogonality, DGKS second pass,
breakdown detection, and active-column masking (the static-shape
contract)."""

import jax.numpy as jnp
import numpy as np
import pytest

from arnoldi_jax.ops.ortho import ORTHO_KERNELS, cgs_dgks, mgs_dgks

KERNELS = [cgs_dgks, mgs_dgks]


def make_basis(rng, n, j, mp1, dtype=np.complex128):
    """Random orthonormal basis in the first j ROWS of an (mp1, n)
    transposed workspace; the remaining rows filled with noise that MUST be
    masked out by the kernels."""
    M = rng.standard_normal((n, j)) + 1j * rng.standard_normal((n, j))
    Q, _ = np.linalg.qr(M)
    Vt = rng.standard_normal((mp1, n)) + 1j * rng.standard_normal((mp1, n))
    Vt[:j, :] = Q.T
    return jnp.asarray(Vt.astype(dtype))


@pytest.mark.parametrize("kernel", KERNELS)
def test_orthogonalizes(kernel, rng):
    n, j, mp1 = 50, 8, 12
    V = make_basis(rng, n, j, mp1)
    w = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))

    h, w2, beta, breakdown = kernel(V, w, j, tol=1e-12)

    # w2 orthogonal to the active rows
    proj = np.asarray(V[:j, :]).conj() @ np.asarray(w2)
    np.testing.assert_allclose(proj, 0, atol=1e-10)
    # inactive coefficient slots untouched (masked)
    np.testing.assert_allclose(np.asarray(h)[j:], 0, atol=0)
    # reconstruction: w = h @ Vt + w2
    recon = np.asarray(h)[:j] @ np.asarray(V[:j, :]) + np.asarray(w2)
    np.testing.assert_allclose(recon, np.asarray(w), atol=1e-10)
    assert not bool(breakdown)
    assert abs(float(beta) - np.linalg.norm(np.asarray(w2))) < 1e-10


@pytest.mark.parametrize("kernel", KERNELS)
def test_breakdown_in_span(kernel, rng):
    n, j, mp1 = 40, 6, 10
    V = make_basis(rng, n, j, mp1)
    # w in the span of the active basis -> breakdown
    coeffs = jnp.asarray(rng.standard_normal(j) + 1j * rng.standard_normal(j))
    w = coeffs @ V[:j, :]

    h, w2, beta, breakdown = kernel(V, w, j, tol=1e-8)
    assert bool(breakdown)
    assert float(beta) < 1e-8
    np.testing.assert_allclose(np.asarray(h)[:j], np.asarray(coeffs), atol=1e-8)


@pytest.mark.parametrize("kernel", KERNELS)
def test_dgks_second_pass_restores_orthogonality(kernel, rng):
    # A vector nearly inside the span exercises the DGKS second pass: a
    # single CGS pass leaves O(eps * cond) junk, the second pass removes it.
    n, j, mp1 = 60, 10, 14
    V = make_basis(rng, n, j, mp1)
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    coeffs = rng.standard_normal(j) + 1j * rng.standard_normal(j)
    w = jnp.asarray(coeffs) @ V[:j, :] + 1e-10 * jnp.asarray(noise)

    h, w2, beta, breakdown = kernel(V, w, j, tol=1e-14)
    assert not bool(breakdown)
    proj = np.asarray(V[:j, :]).conj() @ np.asarray(w2)
    # Relative orthogonality of the surviving component
    np.testing.assert_allclose(proj / float(beta), 0, atol=1e-8)


def test_real_dtype(rng):
    n, j, mp1 = 30, 5, 8
    M = rng.standard_normal((n, j))
    Q, _ = np.linalg.qr(M)
    Vt = np.zeros((mp1, n))
    Vt[:j, :] = Q.T
    w = rng.standard_normal(n)
    h, w2, beta, breakdown = cgs_dgks(jnp.asarray(Vt), jnp.asarray(w), j, tol=1e-12)
    proj = Q.T @ np.asarray(w2)
    np.testing.assert_allclose(proj, 0, atol=1e-12)


def test_registry_variants(rng):
    n, j, mp1 = 30, 5, 8
    V = make_basis(rng, n, j, mp1)
    w = jnp.asarray(rng.standard_normal(n) + 0j)
    for name in ("cgs", "cgs2", "mgs", "cgs_dgks", "mgs_dgks"):
        h, w2, beta, breakdown = ORTHO_KERNELS[name](V, w, j, tol=1e-12)
        proj = np.asarray(V[:j, :]).conj() @ np.asarray(w2)
        np.testing.assert_allclose(proj, 0, atol=1e-8)
