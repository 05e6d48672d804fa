from misinfo_tpu_torch.parallel.sharding import (  # noqa: F401
    detector_pspecs,
    shard_params,
    batch_pspecs,
)
