from .block_jacobi import BlockJacobiPreconditioner
from .block_jacobi_schur import BlockJacobiSchurPreconditioner
from .identity import IdentityPreconditioner

__all__ = ["BlockJacobiPreconditioner", "BlockJacobiSchurPreconditioner",
           "IdentityPreconditioner"]
