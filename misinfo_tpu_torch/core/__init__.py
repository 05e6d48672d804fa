from misinfo_tpu_torch.core.config import (  # noqa: F401
    ForensicsConfig,
    ModelPaths,
    Thresholds,
    MeshConfig,
    PrecisionConfig,
)

# core/mesh.py imports torch; the torch-free host modules (the transcript
# worker's preprocess/audio.py) import core.config alone, so the mesh
# names load on first use
_MESH_NAMES = ("make_mesh", "data_sharding", "replicated")


def __getattr__(name):
    if name in _MESH_NAMES:
        from misinfo_tpu_torch.core import mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_MESH_NAMES))
