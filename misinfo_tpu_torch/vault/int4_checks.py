"""Holding the int4 similarity kernels to their plain versions.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card,
and run on the CPU by ``tests/test_torch_vault_int4.py``, where JAX's
TPU kernels in interpret mode take the kernels' place.

K10b sums int8 · nibble products exactly in int32 and multiplies twice
with IEEE roundings, as its plain version does: it must be equal bit for
bit.

K10a sums f32 products that are exact (a bf16 value times a nibble has
at most 12 significant bits), so it differs from its plain version only
in the order of the D additions. Each order's error is at most
(D − 1)·2^-24·Σ_d |q_d·nib_d| (recursive summation; cuBLAS's blocked
order has the same bound), and each side rounds once more when it scales
by the row's scale. The band, elementwise, is therefore

    |kernel − plain| ≤ (D + 1)·2^-23·Σ_d |q_d·nib_d|·scale[n]

about 1e-4 for a unit 512-d query against random nibbles and a scale of
0.02, against sims of ~0.1. A wrong kernel must leave it: the checks
emulate four faults with the plain version on altered inputs (a
2048-row tile left out, lo and hi nibbles swapped, nibbles read
unsigned, the row scale dropped), and a fifth at a ragged N (the last
partial 128-row tile left out); each must fall outside the band.

The vault of a case is random packed bytes, so every nibble value the
unpacking can see (−8..7) occurs, with scales in [0.01, 0.03] (the
range of unit 512-d rows; ``quantize_rows_int4``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.vault import int4 as K10
from misinfo_tpu_torch.vault.search import exact_matmul

KERNEL_TILE = 128        # rows per tile of csrc/int4_sims.cu
FAULT_TILE = 2048        # rows of the tile left out by the first fault


def vault_case(n: int, d: int = 512, seed: int = 0,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded (packed uint8 [n, d/2], scale f32 [n])."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, size=(n, d // 2), dtype=np.uint8)
    scale = rng.uniform(0.01, 0.03, size=n).astype(np.float32)
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(scale).to(device))


def query_case(b: int, d: int = 512, seed: int = 1,
               device="cpu") -> torch.Tensor:
    """Seeded unit query rows, f32 [b, d]."""
    q = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q).to(device)


def band(query, packed, scale) -> torch.Tensor:
    """K10a's band around its plain version (module docstring)."""
    nib = K10.unpack_int4(packed).float().abs()
    qa = query.to(torch.bfloat16).float().abs()
    d = query.shape[1]
    return (d + 1) * 2.0 ** -23 * exact_matmul(qa, nib.T) * scale[None, :]


def _unsigned_sims(query, packed, scale) -> torch.Tensor:
    p = packed.to(torch.int32)
    nib = torch.cat([p & 0xF, p >> 4], dim=1).float()
    return exact_matmul(query.to(torch.bfloat16), nib.T) * scale[None, :]


def faults(query, packed, scale,
           want: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """What wrong K10a kernels would return, from the plain version."""
    n = packed.shape[0]
    out = []
    t = (n // FAULT_TILE) // 2
    lo, hi = t * FAULT_TILE, min(n, (t + 1) * FAULT_TILE)
    f = want.clone()
    f[:, lo:hi] = 0.0
    out.append((f"rows {lo}..{hi - 1} left out", f))
    if n % KERNEL_TILE:
        f = want.clone()
        f[:, n - n % KERNEL_TILE:] = 0.0
        out.append(("the ragged last tile left out", f))
    swapped = ((packed & 0xF) << 4) | (packed >> 4)
    out.append(("lo/hi nibbles swapped",
                K10.int4_sims_plain(query, swapped, scale)))
    out.append(("nibbles read unsigned",
                _unsigned_sims(query, packed, scale)))
    out.append(("row scale dropped",
                K10.int4_sims_plain(query, packed,
                                    torch.ones_like(scale))))
    return out


def hold(got, want, allowed, fault_list, what: str) -> Dict:
    """Raise unless ``got`` keeps the band around ``want`` and every
    fault leaves it. Returns the largest error, the band's largest width
    and the nearest fault's distance in bands."""
    err = (got.float() - want.float()).abs()
    if not bool((err <= allowed).all()):        # NaN fails here too
        i = err.argmax()
        raise AssertionError(
            f"{what} disagrees with its plain version: max error "
            f"{err.max().item()}, band at that element "
            f"{allowed.flatten()[i].item()}")
    nearest = math.inf
    for name, f in fault_list:
        r = ((f.float() - want.float()).abs() / allowed).max().item()
        if not r > 1.0:
            raise AssertionError(f"{what}: the band does not reject the "
                                 f"planted fault '{name}' ({r} bands)")
        nearest = min(nearest, r)
    return {"err": err.max().item(), "band": allowed.max().item(),
            "faults": len(fault_list), "nearest_fault": nearest}


def check_k10a(query, packed, scale) -> Dict:
    """K10a through its wrapper against the plain version, within the
    band, with every fault outside it."""
    got = K10.int4_sims(query, packed, scale)
    want = K10.int4_sims_plain(query, packed, scale)
    return hold(got, want, band(query, packed, scale),
                faults(query, packed, scale, want),
                f"int4_sims B={query.shape[0]} N={packed.shape[0]}")


def check_k10b(query, packed, scale) -> Dict:
    """K10b through its wrapper against the plain version, bit for bit."""
    got = K10.int4_sims_i8(query, packed, scale)
    want = K10.int4_sims_i8_plain(query, packed, scale)
    if not torch.equal(got, want):
        err = (got - want).abs().max().item()
        raise AssertionError(
            f"int4_sims_i8 B={query.shape[0]} N={packed.shape[0]} differs "
            f"from its plain version (max error {err}); it must be equal "
            "bit for bit")
    return {"err": 0.0}
