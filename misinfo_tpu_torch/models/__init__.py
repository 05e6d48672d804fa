from misinfo_tpu_torch.models.roberta import RobertaConfig, roberta_init, roberta_encode  # noqa: F401
from misinfo_tpu_torch.models.clip import ClipConfig, clip_init  # noqa: F401
from misinfo_tpu_torch.models.efficientnet import effnet_b0_init, effnet_apply  # noqa: F401
from misinfo_tpu_torch.models.fusion import fusion_init, fusion_apply  # noqa: F401
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init  # noqa: F401
