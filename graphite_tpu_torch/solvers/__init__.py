from .dense_cholesky import DenseCholeskySolver
from .dense_cholesky_schur import DenseCholeskySchurSolver
from .pcg import PCGSolver
from .pcg_schur import PCGSchurSolver
from .sparse_direct import SparseDirectSolver
from .sparse_direct_schur import SparseDirectSchurSolver

__all__ = ["PCGSolver", "PCGSchurSolver", "DenseCholeskySolver",
           "DenseCholeskySchurSolver", "SparseDirectSolver",
           "SparseDirectSchurSolver"]
