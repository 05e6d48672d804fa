"""Pre-packed int4 vault sidecars (``<vault>.int4.npz``).

Counterpart of ``misinfo_tpu/vault/prepack.py``, in the same format
(``_FORMAT_VERSION``, keys, content digests of ``vault/ivf.py``), so a
sidecar written by either package loads in the other. Quantizing an
archive-scale vault is host-bound O(N·D) work that would otherwise run at
every engine boot; the sidecar caches the packed nibble planes and per-row
scales beside the vault file and is rebuilt when the vault's content
changes.

Build it offline with::

    python -m misinfo_tpu_torch.vault.prepack path/to/vault.npz

or let the engine build and save it on first boot (a read-only vault
directory only means a rebuild at the next start).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from misinfo_tpu_torch.vault.int4 import Int4Vault, quantize_rows_int4
from misinfo_tpu_torch.vault.ivf import SIDECAR_ERRORS, vault_digest

_FORMAT_VERSION = 1


class PrepackedVault(NamedTuple):
    """Quantized, unpadded planes (the TruthVault's 128-aligned row count;
    the engine pads to the kernel's multiple when it places them)."""
    image: Int4Vault
    text: Optional[Int4Vault]
    digest: str       # image-plane content digest (vault/ivf.py)
    text_digest: str  # text-plane digest, "" when the vault has no titles


def sidecar_path(vault_path: str) -> str:
    return vault_path + ".int4.npz"


def _digests(vault) -> tuple:
    d = vault_digest(vault.embeddings, vault.row_valid)
    td = (vault_digest(vault.text_embeddings, vault.row_valid)
          if vault.text_embeddings is not None else "")
    return d, td


def build_prepacked(vault) -> PrepackedVault:
    """Quantize both planes of a TruthVault (host, one-time)."""
    d, td = _digests(vault)
    return PrepackedVault(
        image=quantize_rows_int4(vault.embeddings),
        text=(quantize_rows_int4(vault.text_embeddings)
              if vault.text_embeddings is not None else None),
        digest=d, text_digest=td)


def save_prepacked(vault_path: str, pre: PrepackedVault) -> str:
    path = sidecar_path(vault_path)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "digest": np.str_(pre.digest),
        "text_digest": np.str_(pre.text_digest),
        "packed": pre.image.packed,
        "scale": pre.image.scale,
    }
    if pre.text is not None:
        payload["text_packed"] = pre.text.packed
        payload["text_scale"] = pre.text.scale
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    # np.savez appends .npz to names lacking it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)
    return path


def load_prepacked(vault_path: str, vault) -> Optional[PrepackedVault]:
    """Digest-validated sidecar load; None when it is missing, stale or
    unreadable (the caller rebuilds). The digest pass reads the f32 planes
    once, far cheaper than re-quantizing, and never serves a stale pack."""
    path = sidecar_path(vault_path)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["version"]) != _FORMAT_VERSION:
                return None
            d, td = _digests(vault)
            if str(z["digest"]) != d or str(z["text_digest"]) != td:
                return None
            image = Int4Vault(packed=z["packed"], scale=z["scale"])
            text = (Int4Vault(packed=z["text_packed"],
                              scale=z["text_scale"])
                    if "text_packed" in z else None)
    except SIDECAR_ERRORS:
        return None
    if image.packed.shape[0] != vault.embeddings.shape[0]:
        return None
    return PrepackedVault(image=image, text=text, digest=d, text_digest=td)


def get_or_build(vault_path: Optional[str], vault,
                 save: bool = True) -> PrepackedVault:
    """Engine entry point: the sidecar when fresh, else quantize (and
    persist for the next boot where the directory is writable)."""
    if vault_path:
        pre = load_prepacked(vault_path, vault)
        if pre is not None:
            return pre
    pre = build_prepacked(vault)
    if save and vault_path:
        try:
            save_prepacked(vault_path, pre)
        except OSError:
            pass  # read-only vault dir: rebuild next start
    return pre


def main(argv=None):
    import argparse
    import time

    from misinfo_tpu_torch.vault.store import TruthVault

    ap = argparse.ArgumentParser(
        description="Pre-pack a Truth Vault for vault_dtype='int4' "
                    "serving (writes <vault>.int4.npz)")
    ap.add_argument("vault", help="vault file (.npz or reference .pkl)")
    ap.add_argument("--force", action="store_true",
                    help="rebuild even if a fresh sidecar exists")
    args = ap.parse_args(argv)

    vault = TruthVault.load(args.vault)
    if vault is None:
        raise SystemExit(f"could not load vault: {args.vault}")
    if not args.force:
        pre = load_prepacked(args.vault, vault)
        if pre is not None:
            print(f"sidecar is fresh: {sidecar_path(args.vault)}")
            return
    t = time.perf_counter()
    pre = build_prepacked(vault)
    path = save_prepacked(args.vault, pre)
    mb = pre.image.packed.nbytes / 1e6
    if pre.text is not None:
        mb += pre.text.packed.nbytes / 1e6
    print(f"packed {vault.num_articles} articles in "
          f"{time.perf_counter() - t:.1f}s -> {path} ({mb:.1f} MB)")


if __name__ == "__main__":
    main()
