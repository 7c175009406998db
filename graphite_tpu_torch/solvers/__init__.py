from .pcg_schur import PCGSchurSolver

__all__ = ["PCGSchurSolver"]
