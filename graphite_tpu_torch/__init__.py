"""graphite_tpu_torch: the PyTorch / CUDA port of graphite_tpu.

A nonlinear least-squares factor-graph optimizer written with PyTorch for
an NVIDIA Hopper GPU. It imports ``torch`` and NumPy only; the JAX package
``graphite_tpu`` beside it is the reference it is tested against.

This slice covers BAL bundle adjustment with Levenberg-Marquardt and PCG on
the Schur complement:

    import torch
    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, synthetic
    from graphite_tpu_torch.optimizers import levenberg_marquardt
    from graphite_tpu_torch.solvers import PCGSchurSolver

    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=FP32_FP32)
    problem = g.freeze(device=torch.device("cuda"))
    result = levenberg_marquardt(problem, PCGSchurSolver(10, 1.0, 5.0))

The same call runs BAL Venice-1778 (``make_bal("venice-big")``), whose pose
system is above ``dense_matvec_limit`` and takes the block-sparse S matvec.
Its Pallas TPU kernels become hand-written CUDA kernels
(``graphite_tpu_torch/csrc``), built with nvcc at first use.
"""

from .factors import Differentiation, FactorSet, FactorType, factor_type
from .graph import Graph, GraphData, Problem
from .linearize import Linearization, apply_update, compute_chi2, linearize
from .loss import CauchyLoss, DefaultLoss, HuberLoss, Loss
from .precision import FP32_FP32, FP64_FP64, Precision
from .vertices import VertexSet, VertexType, vertex_type

__version__ = "0.1.0"

__all__ = [
    "Precision", "FP32_FP32", "FP64_FP64",
    "Loss", "DefaultLoss", "HuberLoss", "CauchyLoss",
    "VertexType", "VertexSet", "vertex_type",
    "FactorType", "FactorSet", "factor_type", "Differentiation",
    "Graph", "Problem", "GraphData",
    "Linearization", "linearize", "compute_chi2", "apply_update",
]
