"""The port's CUDA kernels on the card. Every test here is marked
``cuda`` and skips without an NVIDIA card: a CUDA kernel has no CPU
mode. The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) K1 is held to its
plain PyTorch version within 3 int8 levels (3·max|y|/127), and bit for
bit, which both kernel forms (split chunks at small M, one block per row
tile at large M) have shown on the card.

The decode-step kernels (K6 self-attention, K7 cross-attention + FFN)
are held to their plain versions at whisper-base shapes through
misinfo_tpu_torch/ops/decode_checks.py: elementwise within 2^-5 of the
largest |y − x| (four bf16 steps at the magnitude of what the sub-layer
adds to its residual input; the kernels sum in another order than cuBLAS)
plus one bf16 step of the residual per rounding, with planted keys that
make each head attend to one row and emulated wrong kernels (rows or a T
chunk left out, the mask one row off) that must fall outside that band.

The int4 vault similarity kernels (K10a bf16 query, K10b int8 query) are
held to their plain versions through misinfo_tpu_torch/vault/int4_checks.py:
K10b bit for bit, K10a within (D + 1)·2^-23·Σ|q·nib|·scale per element
(the two sum orders' error bound), with planted faults (a tile or the
ragged edge left out, nibbles swapped or read unsigned, the row scale
dropped) outside that band.
"""

import pytest
import torch

from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import decode_checks as DC
from misinfo_tpu_torch.ops import int8_ffn as K1
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.ops.quant import quantize_dense
from misinfo_tpu_torch.vault import int4 as K10
from misinfo_tpu_torch.vault import int4_checks as IC

D, H, S, T = 512, 8, 448, 1500           # whisper-base decode shapes

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _ffn_args(M, K, N, seed=0):
    gen = torch.Generator().manual_seed(seed)
    args = [torch.randn(M, K, generator=gen).to(torch.bfloat16)]
    for k, n in ((K, N), (N, K)):
        p = quantize_dense({"kernel": torch.randn(k, n, generator=gen) * 0.03,
                            "bias": torch.randn(n, generator=gen) * 0.01})
        args += [p["kernel_q"], p["w_scale"], p["bias"]]
    return [a.cuda() for a in args]


@pytest.mark.parametrize("M,K,N,mode", [(3 * 512, 768, 3072, "tanh"),
                                        (3 * 77, 512, 2048, "quick"),
                                        (3 * 50, 768, 3072, "quick"),
                                        (1, 768, 3072, "erf"),
                                        (5000, 768, 3072, "tanh")])
def test_int8_ffn_kernel_matches_plain(card, M, K, N, mode):
    args = _ffn_args(M, K, N, seed=M)
    before = K1.launches
    y = K1.int8_ffn(*args, mode=mode)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    want = K1.int8_ffn_plain(*args, mode=mode).float()
    assert (y.float() - want).abs().max() < 3 * want.abs().max() / 127
    # same arithmetic in the same order: in practice bit-identical
    assert torch.equal(y.float(), want)


def test_int8_ffn_kernel_refuses_what_it_cannot_run(card):
    args = _ffn_args(4, 768, 3072)
    with pytest.raises(ValueError):                 # f32 input: no fallback
        K1.int8_ffn(args[0].float(), *args[1:], mode="tanh")
    odd = _ffn_args(4, 768, 3072 + 64)              # jc cannot be 128-aligned
    with pytest.raises(RuntimeError):
        K1.int8_ffn(*odd, mode="tanh")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,pos", [(1, 3), (4, 447), (20, 100)])
def test_self_attn_step_kernel_matches_plain(card, int8, B, pos):
    case = DC.self_attn_case(B, pos, int8)
    before = (K6.launches, K6.launches_i8)
    DC.check_self_attn(case)                 # output, faults, cache rows
    torch.cuda.synchronize()
    assert (K6.launches, K6.launches_i8) == (before[0] + 1,
                                             before[1] + int8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,t_actual", [(1, T), (4, T), (20, 1000)])
def test_cross_ffn_step_kernel_matches_plain(card, int8, B, t_actual):
    case = DC.cross_ffn_case(B, t_actual, int8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    before = (K7.launches, K7.launches_i8)
    DC.check_cross_ffn(case, sms)
    torch.cuda.synchronize()
    assert (K7.launches, K7.launches_i8) == (before[0] + 1,
                                             before[1] + int8)


def test_decode_step_kernels_refuse_what_they_cannot_run(card):
    x, ln, qkv, o, ck, cv, _ = DC.self_attn_case(2, 3, True)["args"]
    with pytest.raises(ValueError):                   # pos past the cache
        K6.fused_self_attn_step(x, ln, qkv, o, ck, cv, S, n_heads=H)
    with pytest.raises(ValueError):                   # 32-wide heads
        K6.fused_self_attn_step(x, ln, qkv, o, ck, cv, 0, n_heads=2 * H)
    with pytest.raises(ValueError):                   # f32 caches
        K6.fused_self_attn_step(x, ln, qkv, o, ck.float(), cv.float(), 0,
                                n_heads=H)
    big = K6.MAX_BATCH + 1                            # more rows than MAXB
    with pytest.raises(ValueError):
        K6.fused_self_attn_step(x[:1].expand(big, D).contiguous(), ln, qkv,
                                o, ck[:1].expand(big, S, D).contiguous(),
                                cv[:1].expand(big, S, D).contiguous(), 0,
                                n_heads=H)


@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("N", [K10.INT4_TILE_ROWS * 3, 5000 + 77])
def test_int4_sims_kernels_match_plain(card, B, N):
    packed, scale = IC.vault_case(N, seed=N, device=card)
    q = IC.query_case(B, seed=B, device=card)
    before = (K10.launches, K10.launches_i8)
    res = IC.check_k10a(q, packed, scale)          # band, planted faults
    IC.check_k10b(q, packed, scale)                # bit for bit
    torch.cuda.synchronize()
    assert res["faults"] == (5 if N % IC.KERNEL_TILE else 4)
    assert (K10.launches, K10.launches_i8) == (before[0] + 1, before[1] + 1)


def test_int4_vault_dispatch_on_the_card(card, monkeypatch):
    """From KERNEL_MIN_ROWS aligned rows the dispatcher launches K10b,
    below it K10a; the environment variable forces either."""
    q = IC.query_case(2, device=card)
    for n, env, want in ((K10.KERNEL_MIN_ROWS, "auto", "i8"),
                         (4096, "auto", "bf16"), (4096, "i8", "i8"),
                         (K10.KERNEL_MIN_ROWS, "bf16", "bf16")):
        packed, scale = IC.vault_case(n, device=card)
        monkeypatch.setenv("MISINFO_TPU_INT4_PALLAS", env)
        before = (K10.launches, K10.launches_i8)
        K10.int4_vault_sims(q, packed, scale)
        assert (K10.launches - before[0], K10.launches_i8 - before[1]) == (
            (0, 1) if want == "i8" else (1, 0))


def test_int4_sims_kernels_refuse_what_they_cannot_run(card):
    packed, scale = IC.vault_case(4096, device=card)
    q = IC.query_case(2, device=card)
    for fn in (K10.int4_sims, K10.int4_sims_i8):
        with pytest.raises(ValueError):                # f64 scales
            fn(q, packed, scale.double())
        with pytest.raises(ValueError):                # int8 rows
            fn(q, packed.view(torch.int8), scale)
        with pytest.raises(ValueError):                # packed dim ≠ D/2
            fn(q[:, :256], packed, scale)
        with pytest.raises(ValueError):                # vault on the CPU
            fn(q, packed.cpu(), scale)
        with pytest.raises(ValueError):                # B past MAX_BATCH
            fn(q[:1].expand(K10.MAX_BATCH + 1, 512).contiguous(), packed,
               scale)
        with pytest.raises(ValueError):                # D not a multiple of 32
            fn(q[:, :496].contiguous(), packed[:, :248].contiguous(), scale)
