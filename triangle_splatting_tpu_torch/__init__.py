"""triangle_splatting_tpu_torch — the PyTorch/CUDA port of triangle_splatting_tpu.

The JAX/Pallas package ``triangle_splatting_tpu`` is the reference; this
package reimplements it in PyTorch for NVIDIA Hopper (H100). Plain tensor
code is PyTorch and autograd; the Pallas TPU kernels become hand-written
CUDA kernels (``ops/cuda/csrc``), each with a plain PyTorch version beside
it that runs only for tensors on the CPU.

The module layout mirrors the reference (``ops/``, ``models/``,
``trainers/``, ``utils/``, ``datasets/``). Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when no GPU is present;
only an explicit ``device="cpu"`` runs on the CPU.

This package never imports ``jax`` or ``triangle_splatting_tpu``.
"""

__version__ = "0.1.0"
