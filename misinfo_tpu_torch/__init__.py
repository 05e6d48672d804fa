"""PyTorch/CUDA port of misinfo_tpu for one NVIDIA H100.

Imports torch and never JAX. The sub-packages mirror ``misinfo_tpu``'s
(core, preprocess, ops, models, vault, engine, checkpoints) module for
module; hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use.
"""
