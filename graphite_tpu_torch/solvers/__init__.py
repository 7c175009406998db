from .pcg import PCGSolver
from .pcg_schur import PCGSchurSolver

__all__ = ["PCGSolver", "PCGSchurSolver"]
