"""Holding the int4 similarity kernels to their plain versions.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card,
and run on the CPU by ``tests/test_torch_vault_int4.py``, where JAX's
TPU kernels in interpret mode take the kernels' place.

K10b sums int8 · nibble products exactly in int32 and multiplies twice
with IEEE roundings, as its plain version does: it must be equal bit for
bit.

K10a sums f32 products that are exact (a bf16 value times a nibble has
at most 12 significant bits), so it differs from its plain version only
in how the D products are added. The plain version's order errs by at
most (D − 1)·2^-24·Σ_d |q_d·nib_d| (recursive summation; cuBLAS's
blocked order has the same bound). In the kernel an mma step adds 16
exact products to its f32 C with an error below 17·2^-23 of the largest
of its terms (each of the 17 truncated at most once where they are
aligned, as Fasi et al., 2021, measured tensor cores of earlier
generations to add; the CPU's ``kernel_walk`` rounds once to nearest and
cannot test it, so the card tests hold the band at 160, 256, 512, 768
and 1,024 dims, both sides of the chaining and both tile heights). From
256 dims the eight steps of a 64-byte slice chain in the accumulator, ≤
8·17·2^-23 = 272·2^-24 of the slice's products' absolute sum, and the
D/128 slice sums are added by IEEE additions: ≤ (272 + D/128)·2^-24·Σ in
all, inside the bound below from D = 136. Below 256 dims every step
starts from a zero C (≤ 16·2^-23 of its sum) and is added by an IEEE
addition: ≤ (32 + D/16)·2^-24·Σ. Each side rounds once more when it
scales by the row's scale. The band, elementwise, is therefore

    |kernel − plain| ≤ (D + 1)·2^-23·Σ_d |q_d·nib_d|·scale[n]

about 1e-4 for a unit 512-d query against random nibbles and a scale of
0.02, against sims of ~0.1. A wrong kernel must leave it: the checks
emulate six faults with the plain version on altered inputs (a
2048-row tile left out, one consumer warp's rows left out, the last
64-byte slice's high nibbles left out, lo and hi nibbles swapped,
nibbles read unsigned, the row scale dropped), and a seventh at a ragged
N (the last partial tile left out), at the tile and warp rows the kernel
takes for the call's query (``tiles``); each must fall outside the
band.

The vault of a case is random packed bytes, so every nibble value the
unpacking can see (−8..7) occurs, with scales in [0.01, 0.03] (the
range of unit 512-d rows; ``quantize_rows_int4``).

``kernel_walk`` repeats the kernels' k-walk on the CPU: per 64-byte
slice of a packed row, the low then the high nibbles, in the dims each
mma step of ``csrc/int4_sims.cu`` pairs (K10b: s8 lanes holding 16·v,
exact sums shifted back by 4; K10a: from 256 dims each slice's 128
exact products, below each step's 16, rounded once to f32 and added to
the running f32 sum).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.vault import int4 as K10
from misinfo_tpu_torch.vault.search import exact_matmul

CHAIN_DIMS = 256         # from here K10a chains a slice's mma steps
FAULT_TILE = 2048        # rows of the tile left out by the first fault


def tiles(b: int, d: int, i8: bool = False) -> Tuple[int, int]:
    """(rows of a tile, rows of one consumer warp) of csrc/int4_sims.cu
    for ``b`` query rows of ``d`` dims: four consumer warps of 32 rows up
    to 512 dims, of 16 rows past 512 dims and for K10b's 33-64 query
    rows (the C entry's ``by_batch`` choice)."""
    warp_rows = 16 if d > 512 or (i8 and b > 32) else 32
    return 4 * warp_rows, warp_rows


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
    tile, warp_rows = tiles(*query.shape)
    out = []
    t = (n // FAULT_TILE) // 2
    lo, hi = t * FAULT_TILE, min(n, (t + 1) * FAULT_TILE)
    f = want.clone()
    f[:, lo:hi] = 0.0
    out.append((f"rows {lo}..{hi - 1} left out", f))
    if n % tile:
        f = want.clone()
        f[:, n - n % tile:] = 0.0
        out.append(("the ragged last tile left out", f))
    r0 = min(n - 1, lo + warp_rows)
    f = want.clone()
    f[:, r0:r0 + warp_rows] = 0.0
    out.append((f"one warp's rows {r0}.. left out", f))
    d2 = query.shape[1] // 2
    s0 = (d2 - 1) // 64 * 64
    q = query.clone()
    q[:, d2 + s0:] = 0.0
    out.append(("the last slice's high nibbles left out",
                K10.int4_sims_plain(q, packed, scale)))
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


def walk_steps(d: int, i8: bool) -> List[List[int]]:
    """The dims of each mma step of csrc/int4_sims.cu, in the kernel's
    order: per 64-byte slice s0 of the D/2 packed bytes, the low then the
    high nibbles; lane t (a quad's index) holds bytes s0 + 16t .. + 15,
    and step w pairs its words 2w, 2w + 1 (K10b, m16n8k32: 8 bytes a
    lane) or word w (K10a, m16n8k16: 4 bytes a lane). Lanes past D/2 hold
    zero query fragments and add nothing."""
    d2, width = d // 2, 8 if i8 else 4
    return [[hi * d2 + s0 + 16 * t + width * w + e
             for t in range(4) if s0 + 16 * t < d2 for e in range(width)]
            for s0 in range(0, d2, 64) for hi in (0, 1)
            for w in range(16 // width)]


def kernel_walk(query, packed, scale, i8: bool) -> torch.Tensor:
    """K10b (``i8``) or K10a in the kernels' order and arithmetic
    (module note), on the CPU."""
    nib = K10.unpack_int4(packed)
    steps = walk_steps(query.shape[1], i8)
    if i8:
        qi8, qs = K10.quantize_query_i8(query)
        lanes = (nib * 16).to(torch.int8).long()      # 16·v in s8 lanes
        acc = sum(qi8[:, s].long() @ lanes[:, s].T for s in steps) >> 4
        return acc.float() * scale.float()[None, :] * qs
    if query.shape[1] >= CHAIN_DIMS:          # a slice's 8 steps chain
        steps = [sum(steps[i:i + 8], []) for i in range(0, len(steps), 8)]
    q = query.to(torch.bfloat16).double()
    acc = torch.zeros(query.shape[0], packed.shape[0])
    for s in steps:          # exact products, one rounding, IEEE add
        acc = acc + (q[:, s] @ nib[:, s].double().T).float()
    return acc * scale.float()[None, :]


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
