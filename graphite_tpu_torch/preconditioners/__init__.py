from .block_jacobi import BlockJacobiPreconditioner
from .block_jacobi_schur import (
    BlockJacobiSchurPreconditioner,
    IdentitySchurPreconditioner,
)
from .identity import IdentityPreconditioner

__all__ = ["BlockJacobiPreconditioner", "BlockJacobiSchurPreconditioner",
           "IdentityPreconditioner", "IdentitySchurPreconditioner"]
