"""arnoldi-jax: a Krylov-Schur eigensolver framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
``arnoldi-py`` library (see SURVEY.md).  Public surface mirrors the
reference's (``src/arnoldi/__init__.py:1-3`` exports only ``__version__`` and
``partial_schur``) but additionally exposes the operator layer, solver tiers,
and parallel utilities that the accelerator design adds.
"""

from ._version import __version__
from .solvers.krylov_schur import (
    eigenpairs_from_partial_schur,
    partial_schur,
)
from .solvers.lanczos import partial_eigh
from .solvers.spectral_transform import (
    eigs,
    eigs_realified,
    eigsh,
    generalized_operator,
    realify_operator,
    shift_invert_operator,
)
from .solvers.svd import gram_companions, svds
from .solvers.filtered import eigsh_filtered, eigsh_window
from .solvers.decomposition import RitzDecomposition, arnoldi_decomposition
from .solvers.explicit_restarts import (
    History,
    explicit_restarts_with_deflation,
    naive_explicit_restarts,
)
from .linop import (
    BandedOperator,
    DenseOperator,
    EllOperator,
    LinearOperator,
    as_operator,
)

__all__ = [
    "__version__",
    "partial_schur",
    "eigenpairs_from_partial_schur",
    "partial_eigh",
    "eigs",
    "eigsh",
    "eigsh_filtered",
    "eigsh_window",
    "svds",
    "gram_companions",
    "shift_invert_operator",
    "generalized_operator",
    "realify_operator",
    "eigs_realified",
    "arnoldi_decomposition",
    "RitzDecomposition",
    "History",
    "naive_explicit_restarts",
    "explicit_restarts_with_deflation",
    "LinearOperator",
    "DenseOperator",
    "EllOperator",
    "BandedOperator",
    "as_operator",
]
