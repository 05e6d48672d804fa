from misinfo_tpu_torch.engine.forensics import MisinfoForensics  # noqa: F401
from misinfo_tpu_torch.engine.signals import SignalPrograms  # noqa: F401
