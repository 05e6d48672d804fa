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

Training over a mesh (``setup_train_mesh``, ``place_train_batch``) gives
each data position a replica of the tree (parallel/sharding.py::
``shard_train_params``) and sums gradients over ``data``
(parallel/collectives.py). ``init_multihost`` opens a
``torch.distributed`` group; ``make_mesh()`` then spans every process's
entries in rank order (``Mesh.ranks``), as ``jax.devices()`` is global.
Each process runs the data positions where it holds an entry
(``Mesh.local_data``), with the model positions it holds there
(``Mesh.local_model``): a model group may sit in several processes,
which then exchange through one ``torch.distributed`` group per model
row and one per model column (``Mesh.process_groups``). Serving stays in
one process (``Mesh.require_local``, M15).
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.core.config import MeshConfig


class Mesh:
    """A ``[data, model]`` grid of ``torch.device``. ``shape`` maps each
    axis name to its size, as JAX's (``mesh.shape["data"]``). ``ranks``
    holds the process that owns each entry (all 0 in one process); a
    device is a device of its owner's process."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("data",
                                                              "model"),
                 ranks=None):
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
        self.ranks = (np.zeros(arr.shape, dtype=int) if ranks is None
                      else np.asarray(ranks, dtype=int).reshape(arr.shape))
        self._groups: Optional[Dict[Tuple[int, ...], object]] = None

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

    @property
    def local_data(self) -> List[int]:
        """The data positions where this process holds an entry (all of
        them in one process)."""
        me = process_index()
        return [d for d in range(self.data) if me in self.ranks[d]]

    def local_model(self, d: int) -> List[int]:
        """The model positions of data position ``d`` that this process
        holds."""
        return np.flatnonzero(self.ranks[d] == process_index()).tolist()

    def local_device(self, d: int) -> torch.device:
        """Data position ``d``'s first device in this process: where its
        batch rows and this process's replicated leaves live."""
        return self.devices[d, self.local_model(d)[0]]

    @property
    def multiprocess(self) -> bool:
        return bool((self.ranks != self.ranks.flat[0]).any())

    def row_ranks(self, d: int) -> List[int]:
        """The processes of data position ``d``'s model group, ascending."""
        return sorted(set(self.ranks[d].tolist()))

    def column_ranks(self) -> List[int]:
        """The processes that hold this process's model positions, each
        for its data positions: the ranks whose gradients this one sums
        over ``data``, ascending."""
        mine = self.local_model(self.local_data[0])
        return sorted(set(self.ranks[:, mine].reshape(-1).tolist()))

    def _layout(self) -> None:
        """A ValueError unless every process holds the same model
        positions in each row it touches, as many as every other
        process of the rows, and as many rows as the other processes of
        its column: what ``make_mesh`` gives, whose entries are each
        process's in turn."""
        held: Dict[int, Tuple[int, ...]] = {}
        for d in range(self.data):
            for r in self.row_ranks(d):
                js = tuple(np.flatnonzero(self.ranks[d] == r).tolist())
                if held.setdefault(r, js) != js:
                    raise ValueError(
                        f"rank {r} holds model positions {held[r]} in one "
                        f"row and {js} in another: a training mesh needs "
                        "each process on the same model positions")
        blocks = set(held.values())
        if (len({len(b) for b in blocks}) > 1
                or len({j for b in blocks for j in b})
                != sum(len(b) for b in blocks)):
            raise ValueError(f"the model positions split unevenly over the "
                             f"processes: {sorted(blocks)}")
        rows = {b: {sum(1 for d in range(self.data) if r in self.ranks[d])
                    for r, js in held.items() if js == b} for b in blocks}
        if any(len(n) > 1 for n in rows.values()):
            raise ValueError("the processes of a model column hold unequal "
                             "numbers of data positions")

    def process_groups(self) -> None:
        """Open the mesh's ``torch.distributed`` groups once: one for each
        model row that spans processes and one for each model column,
        each set of ranks once (the world's is the default group). Every
        process calls ``new_group`` for every group, in the same order,
        so this is a collective: every process calls it (training's
        placement does, ``shard_train_params``). A no-op in one
        process."""
        if self._groups is not None:
            return
        if not self.multiprocess:
            self._groups = {}
            return
        import torch.distributed as dist
        self._layout()
        world = tuple(range(process_count()))
        sets = [tuple(self.row_ranks(d)) for d in range(self.data)]
        sets += [tuple(sorted(set(self.ranks[:, m].tolist())))
                 for m in range(self.model)]
        groups: Dict[Tuple[int, ...], object] = {world: dist.group.WORLD}
        for s in sets:
            if len(s) > 1 and s not in groups:
                groups[s] = dist.new_group(list(s))
        self._groups = groups

    def process_group(self, ranks: Sequence[int]):
        """The group ``process_groups`` opened over ``ranks``."""
        self.process_groups()
        return self._groups[tuple(ranks)]

    def require_local(self, what: str) -> None:
        """Refuse ``what`` over a mesh with positions in another process:
        only training runs across processes. JAX's engine reads each
        program's output whole, which JAX refuses for an array partly in
        another process (M15)."""
        if self.multiprocess:
            not_ported(f"{what} over a mesh with positions in another "
                       "process", "M15")

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


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without
    one)."""
    import torch.distributed as dist
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def process_count() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def local_card(rank: Optional[int] = None) -> int:
    """A rank's card: ``cuda:(local_rank % device_count)``, the local rank
    from ``LOCAL_RANK`` (else the rank; default this process's)."""
    rank = process_index() if rank is None else rank
    return (int(os.environ.get("LOCAL_RANK", rank))
            % max(1, torch.cuda.device_count()))


def _local_devices() -> List[torch.device]:
    """This process's entries: ``cpu`` entries after
    ``apply_device_override("cpu")`` (in a run of several processes, each
    provides its share of the provisioned count), else the visible cards
    (one card, ``local_card()``, per process in a run of several)."""
    world = process_count()
    if _platform == "cpu":
        return [torch.device("cpu")] * max(1, _num_cpu_devices // world)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available (pass "
                           "--device cpu for a mesh of CPU entries)")
    if world > 1:
        return [torch.device("cuda", local_card())]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _global_entries() -> List[Tuple[int, torch.device]]:
    """``make_mesh``'s default grid entries with their owners' ranks: the
    visible CUDA cards, and a RuntimeError where there is none; after
    ``apply_device_override("cpu")``, ``MISINFO_TPU_NUM_CPU_DEVICES`` (or
    ``provision_cpu_devices``'s count) ``cpu`` entries. A mesh never falls
    back to the CPU unasked. After ``init_multihost``, every process's
    entries in rank order (a collective: every process calls it), as
    ``jax.devices()`` is global."""
    local = _local_devices()
    if process_count() == 1:
        return [(0, d) for d in local]
    import torch.distributed as dist
    every = [None] * process_count()
    dist.all_gather_object(every, [str(d) for d in local])
    return [(r, torch.device(d)) for r, ds in enumerate(every) for d in ds]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: the visible
    cards, ``_global_entries``). ``data=-1`` takes every device not
    claimed by ``model``. An explicit list may repeat a device."""
    cfg = cfg or MeshConfig()
    if devices is None:
        entries = _global_entries()
        devices = [d for _, d in entries]
        ranks = [r for r, _ in entries]
    else:
        devices = list(devices)
        ranks = [0] * len(devices)
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
    return Mesh(grid, cfg.axis_names, ranks=ranks)


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
    """The trainers' ``--mesh`` plumbing: parse the spec, build the (data,
    model) mesh, check that the batch divides the data axis, and place the
    tree for training (parallel/sharding.py::shard_train_params: a
    replica a data position, the model axis split per
    ``detector_pspecs``, a model group across processes included).
    Returns ``(mesh, params)``; ``(None, params)``
    unchanged without a spec."""
    if not mesh_spec:
        return None, params
    from misinfo_tpu_torch.parallel.sharding import shard_train_params

    mesh = make_mesh(parse_mesh_spec(mesh_spec))
    n_data = mesh.shape["data"]
    if batch_size % n_data:
        raise ValueError(
            f"batch_size {batch_size} not divisible by data axis {n_data}")
    return mesh, shard_train_params(mesh, params)


# the per-slot keys of a packed batch (preprocess/packing.py): they index
# the batch's rows, so they go with the rows they point into
SLOT_KEYS = ("cls_rows", "cls_cols", "labels", "slot_valid")


def place_train_batch(mesh: Optional[Mesh], batch):
    """Host batch dict → tensors. Under a mesh the leading axis splits
    over ``data`` and this process keeps its positions' rows: each key
    becomes a list of pieces, one per ``mesh.local_data`` position, on
    that position's first device in this process (``local_device``:
    every process of a model group gets its position's rows, as each
    runs the position's replica; every process passes the same global
    batch, as ``jax.device_put`` of a global array onto a sharding of
    several processes). A packed batch's per-slot arrays (``SLOT_KEYS``,
    with ``cls_rows``) go with the rows their CLS sits in: position d
    gets the slots whose row is one of its rows, ``cls_rows`` made local,
    padded to the batch's slot count with invalid slots (row 0, weight
    0)."""
    if mesh is None:
        return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    batch = {k: np.asarray(v) for k, v in batch.items()}
    n = mesh.data
    packed = "cls_rows" in batch
    out = {k: [] for k in batch}
    for d in mesh.local_data:
        dev = mesh.local_device(d)
        for k, v in batch.items():
            if packed and k in SLOT_KEYS:
                continue
            if v.shape[0] % n:
                raise ValueError(f"{k}: leading axis {v.shape[0]} not "
                                 f"divisible by the data axis {n}")
            m = v.shape[0] // n
            out[k].append(torch.as_tensor(v[d * m:(d + 1) * m]).to(dev))
        if packed:
            r = batch["input_ids"].shape[0] // n
            rows = batch["cls_rows"]
            mine = np.flatnonzero((rows >= d * r) & (rows < (d + 1) * r)
                                  & (batch["slot_valid"] > 0))
            for k in SLOT_KEYS:
                v = batch[k]
                piece = np.zeros_like(v)
                piece[:len(mine)] = v[mine] - (d * r if k == "cls_rows"
                                               else 0)
                out[k].append(torch.as_tensor(piece).to(dev))
    return out


_MULTIHOST_READY = False


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(
        os.environ.get("MISINFO_TPU_DIST_TIMEOUT_S", "300")))


def dist_backend(num_processes: int) -> Tuple[str, str]:
    """The group's backend and why: ``gloo`` for CPU entries (``--device
    cpu``, or no card); ``nccl`` where each local rank has a card of its
    own (``LOCAL_WORLD_SIZE``, else every process counted local, against
    the visible cards); ``gloo`` where ranks share a card, which NCCL
    refuses ("Duplicate GPU detected")."""
    if _platform == "cpu" or not torch.cuda.is_available():
        return "gloo", "CPU entries"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", f"{local} local ranks, {cards} cards"
    return "gloo", f"{local} local ranks share {cards} card(s)"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Open the ``torch.distributed`` group so that ``make_mesh()`` spans
    every process's entries. Sources, as JAX's: the arguments, or the
    ``JAX_COORDINATOR_ADDRESS`` (``host:port``, taken as
    ``tcp://host:port``) / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    env vars; ``MISINFO_TPU_MULTIHOST=1`` takes torch's own ``env://``
    rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), the counterpart of JAX's TPU-pod probe. The rendezvous
    waits ``MISINFO_TPU_DIST_TIMEOUT_S`` seconds (300). The backend
    follows ``dist_backend`` and is logged; a failed init raises (no
    retry on another backend). Returns True when the group was opened,
    False for the single-process no-op (no arguments, no hint) or when
    a group is already open."""
    global _MULTIHOST_READY
    import torch.distributed as dist

    if _MULTIHOST_READY or dist.is_initialized():
        return False
    coordinator_address = coordinator_address or os.getenv(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.getenv("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.getenv("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if os.getenv("MISINFO_TPU_MULTIHOST") not in ("1", "true", "on"):
            return False  # single-process: nothing to initialize
        init = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        missing = [n for n, v in (("coordinator_address",
                                   coordinator_address),
                                  ("num_processes", num_processes),
                                  ("process_id", process_id)) if v is None]
        if missing:
            raise ValueError(f"init_multihost: {', '.join(missing)} not "
                             "given (argument or JAX_* env var)")
        init = f"tcp://{coordinator_address}"
    backend, why = dist_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(local_card(process_id))
    print(f"init_multihost: rank {process_id} of {num_processes}, backend "
          f"{backend} ({why}), {init}", file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout())
    _MULTIHOST_READY = True
    return True


def shutdown_multihost() -> None:
    """Close the group ``init_multihost`` opened (a no-op without one)."""
    global _MULTIHOST_READY
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _MULTIHOST_READY = False
