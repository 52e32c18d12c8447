"""PyTorch/CUDA port of the DAPC solver stack.

A second package beside the JAX reference ``repro``: same module layout and
public names, PyTorch tensors instead of jax arrays, and the reference's
Pallas TPU kernels rewritten by hand in CUDA C++ for the H100
(``repro_torch/csrc/``). The port imports ``torch`` and numpy, never jax and
never ``repro``.

Entry points (``prepare``, ``solve``, ``launch.solve``) run on the card
unless the caller passes ``device="cpu"`` (see ``repro_torch.device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
