"""Hand-written CUDA kernels for the solver's compute hot-spots.

  * the triangular-substitution initial solve (eqs. 2-3) -- ``trisolve/``
  * the projection application in the consensus update (eqs. 4, 6)
    -- ``project/`` (fused ``x + gamma*(I - W^T W)(xbar - x)``, never
    materializing P)
  * the matrix-free path's blocked-ELL products -- ``spmm/`` (the forward
    SpMM, and the fused pass that also stages the transposed per-tile
    contributions)
  * the consensus loop's residual ||A xbar - b||^2 -- ``residual/`` (the
    products, the subtraction and the sums in one kernel, after a split of
    xbar in float32; the library's product up to 8 columns; the reference
    computes it with plain jnp, so it replaces no Pallas kernel)

Each kernel ships ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built with nvcc
at first use by ``_build.py``), ``ops.py`` (the checked wrapper with its
launch counter) and ``ref.py`` (the plain PyTorch version the CPU path and
the parity tests use).
"""
