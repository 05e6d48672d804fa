"""The serving surfaces' ``--device`` and ``--mesh`` preamble.

Counterpart of ``misinfo_tpu/core/mesh.py::apply_device_override`` and of
the CLI/API ``--mesh`` block. Here the choice is a torch device, handed to
the engine and to the module-cached transcriber alike, so that both run on
one device; or a device mesh (core/mesh.py) that the engine serves over
and the transcriber shards its windows on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from misinfo_tpu_torch.core.mesh import (
    Mesh, apply_device_override, make_mesh, parse_mesh_spec)
from misinfo_tpu_torch.serve.transcript import (
    set_transcriber_device, set_transcriber_mesh)

DEVICE_CHOICES = ("auto", "cuda", "cpu")


def select_device(device: str = "auto",
                  mesh_spec: Optional[str] = None) -> torch.device:
    """``--device`` → the torch device to serve on, also set for the
    module-cached transcriber. ``auto`` and ``cuda`` mean the card and
    raise where there is none (no silent fall back to the CPU); ``cpu``
    only when asked for. ``--device cpu --mesh …`` provisions that many
    ``cpu`` entries for ``make_mesh`` (``select_mesh`` builds the mesh)."""
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
    apply_device_override("cpu" if device == "cpu" else "cuda", mesh_spec)
    set_transcriber_device(dev)
    return dev


def select_mesh(mesh_spec: Optional[str]) -> Optional[Mesh]:
    """``--mesh`` → the mesh over the devices ``select_device`` chose (the
    visible cards, or the provisioned ``cpu`` entries), also set for the
    module-cached transcriber; None without a spec. ``make_mesh`` raises
    JAX's ValueError where the count does not divide."""
    if not mesh_spec:
        return None
    mesh = make_mesh(parse_mesh_spec(mesh_spec))
    set_transcriber_mesh(mesh)      # transcription shards alongside
    return mesh


def select(device: str = "auto", mesh_spec: Optional[str] = None
           ) -> Tuple[torch.device, Optional[Mesh]]:
    """``select_device`` then ``select_mesh``: the entry points' preamble."""
    dev = select_device(device, mesh_spec)
    return dev, select_mesh(mesh_spec)
