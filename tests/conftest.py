"""Test configuration.

Tests run on CPU with x64 enabled (complex128-grade residual checks, parity
with the reference's tolerances) and 8 virtual devices so the sharded paths
exercise a real multi-device mesh without accelerators — the strategy SURVEY
§4 prescribes for testing distribution without a cluster.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the platform to CPU in jax.config as well: a platform plugin that
# updates jax.config at import would otherwise override JAX_PLATFORMS.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Tests matching these nodeid substrings are auto-marked `slow` (measured
# >~10 s serial on this box; mostly dw-refinement/filtered end-to-end runs
# and large halo-SpMV parity sweeps).  The default `make tests` target runs
# `-m "not slow"`; `make tests-all` runs everything.  Centralised here so
# duration-tier policy lives in one place instead of scattered decorators.
_SLOW_NODEID_PARTS = (
    "test_halo_spmv.py::test_matches_dense",
    "test_halo_spmv.py::TestDwHalo",
    "test_halo_spmv.py::test_zero_halo",
    "test_halo_spmv.py::test_closure_in_solver",
    "test_halo_spmv.py::TestScatteredHalo::test_ell_matches_single_device",
    "test_operators.py::test_matvec_matches_scipy[banded-random",
    "test_svd_generalized.py::TestSvds::test_f32_dw_refinement",
    "test_svd_generalized.py::TestSvds::test_block_svds",
    "test_svd_generalized.py::TestSvds::test_bsr_adjoint_matvec",
    "test_svd_generalized.py::TestRealified::test_sparse_complex",
    "test_svd_generalized.py::TestRealified::test_realified_multiplicity",
    "test_svd_generalized.py::TestRealified::test_dense_complex_matches_arpack",
    "test_svd_generalized.py::TestGeneralized::test_eigsh_be_standard",
    "test_svd_generalized.py::TestGeneralized::test_eigsh_generalized_la_sa",
    "test_svd_generalized.py::TestGeneralized::test_minv_opinv_explicit",
    "test_spectral_transform.py::TestShiftInvertRobustness::test_eigsh_interior_shift_gmres",
    "test_spectral_transform.py::TestRealifiedAdversarial",
    "test_spectral_transform.py::TestStartVectorV0::test_realified_v0_complex",
    "test_refine.py::TestRefinedSolvers",
    "test_refine.py::TestRefineBsr",
    "test_refine.py::TestHostTrafficPaths",
    "test_refine.py::TestDwMatvecFusion",
    "test_parallel.py::test_sharded_refine",
    "test_harness.py::test_drivers_agree",
    "test_filtered.py::TestFilteredMesh",
    "test_filtered.py::TestFilteredDwRefine",
    "test_filtered.py::TestEigshWindow",
    "test_filtered.py::TestEigshFiltered::test_matches_shift_invert",
    "test_filtered.py::TestEigshFiltered::test_laplace_interior",
    "test_filtered.py::TestEigshFiltered::test_laplace_2d_window",
    "test_explicit_restarts.py::TestExplicitRestartsWithDeflation",
    "test_block_lanczos.py::TestBlockPartialEigh::test_sharded_block",
    "test_block_lanczos.py::TestBlockPartialEigh::test_degenerate_multiplicity",
    "test_block_lanczos.py::TestBlockKrylovSchur::test_degenerate_nonhermitian",
    "test_block_lanczos.py::TestBlockKrylovSchur::test_mark_block_matches_arpack",
    "test_multihost_spawn.py",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end test (excluded from `make tests`)"
    )


def pytest_collection_modifyitems(config, items):
    slow = pytest.mark.slow
    for item in items:
        if any(part in item.nodeid for part in _SLOW_NODEID_PARTS):
            item.add_marker(slow)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
