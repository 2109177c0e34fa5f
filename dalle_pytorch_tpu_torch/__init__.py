"""PyTorch/CUDA port of ``dalle_pytorch_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path (``ops/``, ``models/``, ``serving/``) and is held
against it by ``tests/test_torch_*.py``. This package imports ``torch``
and never JAX or anything of the JAX package. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor every
kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches its hand-written kernel or raises.
"""
