"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- ``segsum`` / ``segsum_stream``: kernel K1, the sorted segmented row sum
  (``csrc/segsum.cu``);
- ``pcg_dense``: kernel K2, a whole block-Jacobi PCG solve in one launch
  on one thread-block cluster (``csrc/pcg_dense.cu``);
- ``segsum_stream``: kernel K3, the gathered triple product reduced over
  sorted segments (``csrc/segprod.cu``), and K4's
  ``streaming_matvec_tbl``;
- ``segmv``: kernel K4, the gathered block matvec reduced over segments,
  and K5, the symmetric block-sparse S matvec (``csrc/segmv.cu``);
- ``pcg_mf``: kernel K6, a whole matrix-free PCG solve of a pose graph
  in one launch on one thread-block cluster (``csrc/pcg_mf.cu``);
- ``bal``: kernel K7, the BAL reprojection factor's per-factor
  linearization and Hessian values (``csrc/bal.cu``);
- ``allreduce``: kernel K8, the sharded path's rank-order all-reduce and
  gather over CUDA IPC (``csrc/allreduce.cu``);
- ``dot``: kernel K9, the PCG's inner product in ``pcg_loop.tree_sum``'s
  order, one launch a dot (``csrc/dot.cu``);
- ``schur_w``: kernel K10, the Schur complement's landmark inverses and
  W = Hpl Hll^-1, one launch per Hpl group, and K13, the landmark solve
  w = Hll^-1 (t - sub) (``csrc/schur_w.cu``);
- ``pcg_step``: kernel K12, the CG step's vector work (block-Jacobi-Schur
  apply with the residual's normalisation, the x / r update, the step's
  commit) in three launches (``csrc/pcg_step.cu``);
- ``pose``: kernel K11, the SE(3) pose-graph factors' linearization by
  forward-mode dual numbers, chi2 and update (``csrc/pose.cu``);
- ``cond``: the conditional graph nodes of the captured LM iteration
  (``csrc/cond.cu``).

Each wrapper has a plain PyTorch version beside it with the same
signature, used for CPU tensors and as the kernel's oracle, and a
``LaunchStats`` launch count per entry point.
"""
