from .block_jacobi_schur import BlockJacobiSchurPreconditioner

__all__ = ["BlockJacobiSchurPreconditioner"]
