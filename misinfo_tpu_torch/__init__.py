"""PyTorch/CUDA port of misinfo_tpu for one NVIDIA H100.

Imports torch and never JAX. The sub-packages mirror ``misinfo_tpu``'s
(core, preprocess, ops, models, vault, engine, checkpoints, serve) module for
module; hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use.
"""


def not_ported(what: str, item: str):
    """Raise NotImplementedError for a part of ``misinfo_tpu`` that this
    package does not carry yet, naming its ROADMAP.md item."""
    raise NotImplementedError(
        f"{what} is not ported to misinfo_tpu_torch yet (ROADMAP.md {item})")
