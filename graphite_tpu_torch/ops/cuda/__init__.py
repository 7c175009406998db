"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- ``segsum`` / ``segsum_stream``: kernel K1, the sorted segmented row sum
  (``csrc/segsum.cu``);
- ``pcg_dense``: kernel K2, a whole block-Jacobi PCG solve in one launch
  (``csrc/pcg_dense.cu``);
- ``segsum_stream``: kernel K3, the gathered triple product reduced over
  sorted segments (``csrc/segprod.cu``), and K4's
  ``streaming_matvec_tbl``;
- ``segmv``: kernel K4, the gathered block matvec reduced over segments,
  and K5, the symmetric block-sparse S matvec (``csrc/segmv.cu``).

Each wrapper has a plain PyTorch version beside it with the same
signature, used for CPU tensors and as the kernel's oracle, and a
``LaunchStats`` launch count per entry point.
"""
