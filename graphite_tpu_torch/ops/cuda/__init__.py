"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- ``segsum`` / ``segsum_stream``: kernel K1, the sorted segmented row sum
  (``csrc/segsum.cu``);
- ``pcg_dense``: kernel K2, a whole block-Jacobi PCG solve in one launch
  (``csrc/pcg_dense.cu``).

Each wrapper has a plain PyTorch version beside it with the same
signature, used for CPU tensors and as the kernel's oracle, and a
``STATS`` launch count.
"""
