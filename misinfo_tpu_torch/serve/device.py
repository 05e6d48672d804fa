"""The serving surfaces' ``--device`` and ``--mesh`` preamble.

Counterpart of ``misinfo_tpu/core/mesh.py::apply_device_override``, which
flips the JAX platform. Here the choice is a torch device, handed to the
engine and to the module-cached transcriber alike, so that both run on
one device.
"""

from __future__ import annotations

from typing import Optional

import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.serve.transcript import set_transcriber_device

DEVICE_CHOICES = ("auto", "cuda", "cpu")


def select_device(device: str = "auto",
                  mesh_spec: Optional[str] = None) -> torch.device:
    """``--device`` → the torch device to serve on, also set for the
    module-cached transcriber. ``auto`` and ``cuda`` mean the card and
    raise where there is none (no silent fall back to the CPU); ``cpu``
    only when asked for. A ``--mesh`` is refused (multi-GPU, M17)."""
    if mesh_spec:
        not_ported(f"--mesh {mesh_spec} (serving over a device mesh)", "M17")
    if device not in DEVICE_CHOICES:
        raise ValueError(f"--device {device!r}: expected one of "
                         f"{', '.join(DEVICE_CHOICES)}")
    if device == "cpu":
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    else:
        dev = torch.device("cuda")
    set_transcriber_device(dev)
    return dev
