from misinfo_tpu_torch.ops.common import (  # noqa: F401
    Policy,
    dense,
    layer_norm,
    dense_init,
    layer_norm_init,
)
from misinfo_tpu_torch.ops.attention import multi_head_attention  # noqa: F401
from misinfo_tpu_torch.ops.image_ops import normalize_images  # noqa: F401
