"""Device mesh construction and sharding helpers.

Counterpart of ``misinfo_tpu/core/mesh.py``. JAX serves a mesh as one
program that GSPMD partitions; here one process drives a ``[data, model]``
grid of ``torch.device`` entries (``Mesh``). Request batches split their
leading axis over ``data`` and each data position runs its program on
its own device; transformer heads and FFN columns may split over
``model`` (parallel/sharding.py, parallel/tensor.py). A grid may name a
device more than once: ``data=2`` over ``cuda:0`` twice runs every
sharded code path on one card, and the CPU tests run the same code over
a grid of ``cpu`` entries.

A sharding is a ``NamedSharding(mesh, spec)`` whose spec is a tuple of
axis names or None per dimension (``PartitionSpec``). A batch placed
with ``shard_batch`` is a dict of lists: one tensor per data position,
on that position's first device.

Training over a mesh (``setup_train_mesh``, ``place_train_batch``) and
the multi-process runtime (``init_multihost`` with a coordinator) need
more than one process and are ROADMAP.md M17b: refused by name.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.core.config import MeshConfig


class Mesh:
    """A ``[data, model]`` grid of ``torch.device``. ``shape`` maps each
    axis name to its size, as JAX's (``mesh.shape["data"]``)."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("data",
                                                              "model")):
        rows = [list(r) for r in devices]
        if (len(axis_names) != 2 or not rows
                or len({len(r) for r in rows}) != 1 or not rows[0]):
            raise ValueError("a Mesh is a 2-D [data, model] device grid")
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, r in enumerate(rows):
            for j, d in enumerate(r):
                arr[i, j] = torch.device(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data(self) -> int:
        return int(self.devices.shape[0])

    @property
    def model(self) -> int:
        return int(self.devices.shape[1])

    def row(self, d: int) -> List[torch.device]:
        """The model group of data position ``d``."""
        return list(self.devices[d])

    @property
    def data_devices(self) -> List[torch.device]:
        """Each data position's first device: where its batch shard and
        its replicated leaves live."""
        return [self.devices[d, 0] for d in range(self.data)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec`` as a tuple of axis names (or None) per
    dimension: ``PartitionSpec(None, "model") == (None, "model")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


# ``--device`` choice and provisioned CPU entries (apply_device_override,
# provision_cpu_devices): what make_mesh() takes by default
_platform = "auto"
_num_cpu_devices = int(os.environ.get("MISINFO_TPU_NUM_CPU_DEVICES", "1")
                       or 1)


def default_devices() -> List[torch.device]:
    """``make_mesh``'s default grid entries: the visible CUDA cards, and
    a RuntimeError where there is none; after ``apply_device_override(
    "cpu")``, ``MISINFO_TPU_NUM_CPU_DEVICES`` (or ``provision_cpu_devices``'s
    count) ``cpu`` entries. A mesh never falls back to the CPU unasked."""
    if _platform == "cpu":
        return [torch.device("cpu")] * _num_cpu_devices
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available (pass "
                           "--device cpu for a mesh of CPU entries)")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: the visible
    cards, ``default_devices``). ``data=-1`` takes every device not
    claimed by ``model``. An explicit list may repeat a device."""
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    model = max(1, cfg.model)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices):
        grid[i // model, i % model] = torch.device(d)
    return Mesh(grid, cfg.axis_names)


def data_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (batch) axis on ``data``, replicate the rest."""
    return NamedSharding(mesh, P(mesh.axis_names[0], *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def split_rows(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x``'s leading axis in ``data`` equal pieces, piece d on data
    position d's device (a ValueError if the axis does not divide)."""
    n = mesh.data
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by the "
                         f"data axis {n}")
    return [c.to(dev, non_blocking=True)
            for c, dev in zip(torch.chunk(x, n, dim=0), mesh.data_devices)]


def shard_batch(mesh: Mesh, tree):
    """Place every tensor of ``tree`` with its leading axis sharded on
    ``data``: each becomes a list of per-position pieces."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return split_rows(torch.as_tensor(tree), mesh)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def parse_mesh_spec(spec: str) -> MeshConfig:
    """Parse a CLI mesh spec: ``"data=8"``, ``"data=4,model=2"``, or a bare
    device count (data-parallel only)."""
    spec = spec.strip()
    if spec.isdigit():
        return MeshConfig(data=int(spec), model=1)
    kv = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in ("data", "model") or not v.strip().lstrip("-").isdigit():
            raise ValueError(f"bad mesh spec {spec!r}; use 'data=N[,model=M]'")
        kv[k] = int(v)
        # only data=-1 ('all remaining devices') is a legal non-positive
        # value; anything else is a typo that make_mesh would silently
        # reinterpret as 'all devices'
        if kv[k] < 1 and not (k == "data" and kv[k] == -1):
            raise ValueError(f"bad mesh spec {spec!r}: {k}={kv[k]} "
                             "(use positive counts, or data=-1 for all)")
    return MeshConfig(data=kv.get("data", -1), model=kv.get("model", 1))


def provision_cpu_devices(spec: str) -> MeshConfig:
    """``--device cpu --mesh …``: parse the spec and make ``make_mesh()``'s
    default a grid of data×model ``cpu`` entries (``data=-1`` counts 1).
    Returns the parsed MeshConfig."""
    global _num_cpu_devices
    mc = parse_mesh_spec(spec)
    need = max(mc.data, 1) * max(mc.model, 1)
    if need > 1:
        _num_cpu_devices = need
    return mc


def apply_device_override(device: str,
                          mesh_spec: Optional[str] = None) -> None:
    """Shared ``--device`` preamble: ``cpu`` or ``cuda`` picks the entries
    ``make_mesh()`` takes by default, and ``--device cpu --mesh …``
    provisions that many ``cpu`` entries. ``auto`` changes nothing."""
    global _platform
    if device == "auto":
        return
    if device not in ("cpu", "cuda"):
        raise ValueError(f"--device {device!r}: expected auto, cuda or cpu")
    _platform = device
    if device == "cpu" and mesh_spec:
        provision_cpu_devices(mesh_spec)


def setup_train_mesh(mesh_spec: Optional[str], params, batch_size: int):
    """The trainers' ``--mesh`` plumbing: ``(None, params)`` unchanged
    without a spec; training over a mesh is M17b."""
    if not mesh_spec:
        return None, params
    not_ported(f"setup_train_mesh({mesh_spec!r}) (training over a device "
               "mesh)", "M17b")


def place_train_batch(mesh: Optional[Mesh], batch):
    """Host batch dict → tensors (no mesh); a mesh is M17b."""
    if mesh is not None:
        not_ported("place_train_batch(mesh=...) (training over a device "
                   "mesh)", "M17b")
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """The single-process no-op of JAX's ``init_multihost``: False with no
    arguments and no ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` / ``MISINFO_TPU_MULTIHOST`` hint. Any hint asks for
    a multi-process runtime, which is M17b."""
    hinted = (coordinator_address is not None or num_processes is not None
              or process_id is not None
              or any(os.getenv(k) for k in ("JAX_COORDINATOR_ADDRESS",
                                            "JAX_NUM_PROCESSES",
                                            "JAX_PROCESS_ID"))
              or os.getenv("MISINFO_TPU_MULTIHOST") in ("1", "true", "on"))
    if hinted:
        not_ported("init_multihost with a multi-process hint (one process "
                   "per card, torch.distributed)", "M17b")
    return False
