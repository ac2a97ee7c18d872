from .suite import (
    EigensolverParameters,
    Statistics,
    arnoldi_jax_eig,
    arpack_eig,
    find_best_matching,
    matrix_from_spec,
    print_residuals,
)

__all__ = [
    "EigensolverParameters",
    "Statistics",
    "arpack_eig",
    "arnoldi_jax_eig",
    "find_best_matching",
    "matrix_from_spec",
    "print_residuals",
]
