"""Dense-tier tests: ordered Schur correctness against the reference's
golden construction (and SciPy-derived ARPACK tolerances), trexc moves,
and triangular eigenvector back-substitution."""

import numpy as np
import pytest

from arnoldi_jax.ops import dense_tier
from arnoldi_jax.ops.dense_tier import (
    eig_from_schur,
    move_eigenvalue,
    ordered_schur,
    schur_complex,
)


def _get_test_tolerance(type_char):
    # Tolerances lifted from SciPy's ARPACK test suite (same provenance as
    # the reference, tests/test_utils.py:8-19).
    rtol = {
        "f": 3000 * np.finfo(np.float32).eps,
        "d": 2000 * np.finfo(np.float64).eps,
    }
    for k in ["f", "d"]:
        rtol[k.upper()] = rtol[k]
    return rtol[type_char], rtol[type_char]


class TestOrderedSchur:
    @pytest.mark.parametrize("dtype", ["F", "D"])
    def test_simple_complex(self, dtype):
        r_T = np.array(
            [
                [5.0, 1.5, 0.8, 0.1, 0.4],
                [0.0, 4.0, 1.2, 1.0, 0.5],
                [0.0, 0.0, 3.0, 1.0, 0.3],
                [0.0, 0.0, 0.0, 2.0, 0.6],
                [0.0, 0.0, 0.0, 0.0, 1.0],
            ]
        ).astype(dtype)

        rng = np.random.default_rng(23)
        r_Q, _ = np.linalg.qr(rng.standard_normal(r_T.shape).astype(dtype))
        A = r_Q.T @ r_T @ r_Q

        rtol, atol = _get_test_tolerance(dtype)

        T, Q = ordered_schur(A, output="complex",
                             sort_function=lambda v: np.argsort(v))

        assert T.dtype == np.dtype(dtype)
        assert Q.dtype == np.dtype(dtype)
        np.testing.assert_allclose(Q @ T @ Q.T.conj(), A, rtol=rtol, atol=atol)
        np.testing.assert_allclose(np.diag(T), [1, 2, 3, 4, 5],
                                   rtol=rtol, atol=atol)
        # T stays upper triangular
        np.testing.assert_allclose(T, np.triu(T), atol=atol)

    def test_real_output_unsupported(self):
        A = np.eye(3)
        with pytest.raises(ValueError, match="not implemented"):
            ordered_schur(A, output="real")

    def test_random_permutations(self):
        rng = np.random.default_rng(3)
        n = 12
        A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
        ref_vals = np.sort_complex(np.linalg.eigvals(A))

        for which in ("LM", "LR", "SM"):
            from arnoldi_jax.utils.sorting import sort_function_for

            sf = sort_function_for(which)
            T, Q = ordered_schur(A, sort_function=sf)
            np.testing.assert_allclose(Q @ T @ Q.conj().T, A,
                                       rtol=1e-10, atol=1e-10)
            d = np.diag(T)
            # diagonal is in the order the sort function dictates
            want = np.sort_complex(np.linalg.eigvals(A))
            got_sorted = d[np.argsort(np.arange(n))]
            idx = sf(d)
            np.testing.assert_array_equal(idx, np.arange(n))
            np.testing.assert_allclose(
                np.sort_complex(d), ref_vals, rtol=1e-10, atol=1e-10
            )


class TestTrexc:
    def test_move_preserves_similarity(self):
        rng = np.random.default_rng(5)
        n = 8
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        T, Z = schur_complex(A)
        d_before = np.diag(T).copy()

        T2, Z2 = move_eigenvalue(T.copy(), Z.copy(), 5, 1)

        np.testing.assert_allclose(Z2 @ T2 @ Z2.conj().T, A,
                                   rtol=1e-10, atol=1e-10)
        assert abs(T2[1, 1] - d_before[5]) < 1e-10
        np.testing.assert_allclose(
            np.sort_complex(np.diag(T2)), np.sort_complex(d_before),
            rtol=1e-10, atol=1e-10,
        )


class TestEigFromSchur:
    def test_matches_numpy(self):
        rng = np.random.default_rng(7)
        n = 10
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        T, Z = schur_complex(A)
        vals, vecs = eig_from_schur(T, Z)
        # A vecs = vals * vecs
        res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-9)

    def test_triangular_only(self):
        rng = np.random.default_rng(9)
        n = 6
        T = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
        vals, S = eig_from_schur(T)
        res = np.linalg.norm(T @ S - vals * S, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-10)
        np.testing.assert_allclose(np.linalg.norm(S, axis=0), 1, atol=1e-12)
