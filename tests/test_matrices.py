"""Golden-value tests for the matrix generators (parity with the reference's
``tests/test_matrices.py`` goldens, plus structural checks)."""

import numpy as np
import numpy.linalg as nlin

from arnoldi_jax.matrices import (
    laplace,
    laplace_2d,
    laplace_2d_eigen,
    laplace_eigen,
    mark,
)


class TestMark:
    def test_mark_2(self):
        r_mark = np.array(
            [[0.0, 1.0, 1.0],
             [0.5, 0.0, 0.0],
             [0.5, 0.0, 0.0]]
        )
        np.testing.assert_array_almost_equal(mark(2).todense(), r_mark)

    def test_mark_3(self):
        r_mark = np.array(
            [[0.0, 0.5, 0.0, 0.5, 0.0, 0.0],
             [0.5, 0.0, 1.0, 0.0, 0.5, 0.0],
             [0.0, 0.25, 0.0, 0.0, 0.0, 0.0],
             [0.5, 0.0, 0.0, 0.0, 0.5, 1.0],
             [0.0, 0.25, 0.0, 0.25, 0.0, 0.0],
             [0.0, 0.0, 0.0, 0.25, 0.0, 0.0]]
        )
        np.testing.assert_array_almost_equal(mark(3).todense(), r_mark)

    def test_mark_column_stochastic(self):
        # Transition weights into each state sum to one (the walk conserves
        # probability), for any grid size.
        for m in (2, 3, 5, 10, 17):
            A = mark(m)
            np.testing.assert_allclose(
                np.asarray(A.sum(axis=0)).ravel(), 1.0, atol=1e-12
            )

    def test_mark_dominant_eigenvalue(self):
        # A column-stochastic matrix has spectral radius 1.
        A = mark(10)
        vals = nlin.eigvals(A.todense())
        assert abs(np.max(np.abs(vals)) - 1.0) < 1e-10


class TestLaplace:
    def test_laplace_5(self):
        r_m = np.array(
            [[-2.0, 1.0, 0.0, 0.0, 0.0],
             [1.0, -2.0, 1.0, 0.0, 0.0],
             [0.0, 1.0, -2.0, 1.0, 0.0],
             [0.0, 0.0, 1.0, -2.0, 1.0],
             [0.0, 0.0, 0.0, 1.0, -2.0]]
        )
        np.testing.assert_array_almost_equal(laplace(5).todense(), r_m)

    def test_laplace_eivals(self):
        m = laplace(5).todense()
        r_eivals = np.sort(nlin.eig(m)[0])[::-1]
        np.testing.assert_array_almost_equal(laplace_eigen(5), r_eivals)

    def test_laplace_2d_spectrum(self):
        A = laplace_2d(4, 3).todense()
        got = np.sort(nlin.eigvalsh(A))
        want = np.sort(laplace_2d_eigen(4, 3))
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_laplace_2d_structure(self):
        A = laplace_2d(3)
        assert A.shape == (9, 9)
        d = A.todense()
        np.testing.assert_allclose(np.diag(d), -4.0)
        np.testing.assert_allclose(d, d.T)


def test_laplace_3d_golden():
    from arnoldi_jax.matrices import laplace_3d, laplace_3d_eigen

    A = laplace_3d(7)
    w = np.linalg.eigvalsh(np.asarray(A.todense()))
    np.testing.assert_allclose(np.sort(laplace_3d_eigen(7)), w, atol=1e-10)
    B = laplace_3d(3, 4, 5)
    assert B.shape == (60, 60)
    wb = np.linalg.eigvalsh(np.asarray(B.todense()))
    np.testing.assert_allclose(np.sort(laplace_3d_eigen(3, 4, 5)), wb,
                               atol=1e-10)
