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

SE3 / SE2 pose graphs (g2o files or the synthetic generators) run with
Levenberg-Marquardt and matrix-free block-Jacobi PCG; the factors are
differentiated automatically through the pose retraction:

    from graphite_tpu_torch.io import g2o
    from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
    from graphite_tpu_torch.solvers import PCGSolver

    g, *_ = g2o.build_graph(synthetic.make_sphere_se3(2500, seed=0),
                            precision=FP32_FP32)
    result = levenberg_marquardt(
        g.freeze(), PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()))

Every call takes any of the JAX package's six precision policies
(``FP64_FP64``, ``FP64_FP32``, ``FP64_BF16``, ``FP32_FP32``, ``FP32_BF16``,
``FP32_FP16``; ``Precision.from_names("fp32", "bf16")``).

Besides Levenberg-Marquardt (``levenberg_marquardt``,
``levenberg_marquardt2``), ``optimizers`` has ``gradient_descent`` and
``adam`` (each iteration captured once as a CUDA graph on the card and
replayed); ``covariance`` recovers joint and marginal covariances through
the dense or the Schur path; ``io.checkpoint`` saves and loads parameters
as ``.npz`` files the JAX package reads too; the command-line examples
are ``python -m graphite_tpu_torch.examples.bal``, ``.pose_graph``,
``.circle`` and ``.range_bearing_slam``:

    from graphite_tpu_torch.covariance import marginal_covariances
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.optimizers import (
        GradientDescentOptions,
        gradient_descent,
    )

    params, hist = gradient_descent(problem, options=GradientDescentOptions(
        iterations=30, learning_rate=0.1))
    sigma = marginal_covariances(problem, linearize(problem, params),
                                 [("bal_camera", 0)], damping=1e-2)

``freeze()`` builds on the CUDA card unless asked for ``device="cpu"``.
The Pallas TPU kernels become hand-written CUDA kernels
(``graphite_tpu_torch/csrc``), built with nvcc at first use.
"""

from .covariance import joint_covariance, marginal_covariances
from .factors import Differentiation, FactorSet, FactorType, factor_type
from .graph import Graph, GraphData, Problem
from .linearize import (
    JtPv,
    Jv,
    Linearization,
    apply_update,
    compute_chi2,
    hessian_matvec,
    linearize,
)
from .loss import CauchyLoss, DefaultLoss, HuberLoss, Loss
from .precision import (
    FP32_BF16,
    FP32_FP16,
    FP32_FP32,
    FP64_BF16,
    FP64_FP32,
    FP64_FP64,
    Precision,
)
from .vertices import VertexSet, VertexType, vertex_type

__version__ = "0.1.0"

__all__ = [
    "Precision", "FP64_FP64", "FP64_FP32", "FP64_BF16", "FP32_FP32",
    "FP32_BF16", "FP32_FP16",
    "Loss", "DefaultLoss", "HuberLoss", "CauchyLoss",
    "VertexType", "VertexSet", "vertex_type",
    "FactorType", "FactorSet", "factor_type", "Differentiation",
    "Graph", "Problem", "GraphData",
    "Linearization", "linearize", "compute_chi2", "apply_update",
    "Jv", "JtPv", "hessian_matvec",
    "joint_covariance", "marginal_covariances",
]
