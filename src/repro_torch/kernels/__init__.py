"""Hand-written CUDA kernels for the solver's compute hot-spots.

  * the triangular-substitution initial solve (eqs. 2-3) -- ``trisolve/``
  * the projection application in the consensus update (eqs. 4, 6)
    -- ``project/`` (fused ``x + gamma*(I - W^T W)(xbar - x)``, never
    materializing P)

Each kernel ships ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built with nvcc
at first use by ``_build.py``), ``ops.py`` (the checked wrapper with its
launch counter) and ``ref.py`` (the plain PyTorch version the CPU path and
the parity tests use). The blocked-ELL SpMM kernels of the matrix-free path
are not ported yet (ROADMAP Queue 2, items 3-4).
"""
