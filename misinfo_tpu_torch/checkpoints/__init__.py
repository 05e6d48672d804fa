from misinfo_tpu_torch.checkpoints.torch_convert import (  # noqa: F401
    convert_roberta,
    convert_head,
    convert_fusion,
    convert_efficientnet,
    convert_clip,
)
