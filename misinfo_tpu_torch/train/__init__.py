from misinfo_tpu_torch.train.losses import (  # noqa: F401
    cross_entropy,
    clip_contrastive_loss,
    median_threshold_accuracy,
)
from misinfo_tpu_torch.train.optim import make_optimizer, OptimConfig  # noqa: F401
