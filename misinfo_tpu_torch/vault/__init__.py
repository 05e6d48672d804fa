from misinfo_tpu_torch.vault.store import TruthVault  # noqa: F401
from misinfo_tpu_torch.vault.search import vault_search  # noqa: F401
