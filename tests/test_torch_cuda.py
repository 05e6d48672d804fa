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

K8 (the cross step over int8 cross planes) is held to its plain version
through the same module at the three V tile widths and a ragged single
tile: the bf16-plane band plus one level of every quantized probability
that sits at a rounding boundary, with planted faults (V scales applied
late, K scales dropped, the probabilities' scale per head, half-size
tiles, a score chunk or a V piece left out, the mask one row off)
outside. K9 (the whole-layer step) must equal K6b followed by K7b bit
for bit, output and caches, in one ``__global__`` launch per call, and
keep the band of its plain version.

The int4 vault similarity kernels (K10a bf16 query, K10b int8 query) are
held to their plain versions through misinfo_tpu_torch/vault/int4_checks.py:
K10b bit for bit, K10a within (D + 1)·2^-23·Σ|q·nib|·scale per element
(the two sum orders' error bound), with planted faults (a tile or the
ragged edge left out, nibbles swapped or read unsigned, the row scale
dropped) outside that band.

The detector's opt-in kernels (K2 int8 dense, K3 fused attention, K4
LayerNorm, K5 fused FFN) are held to their plain versions at the main
path's shapes through misinfo_tpu_torch/ops/kernel_checks.py: K2 bit for
bit, K3-K5 within the bands that module derives, with its planted faults
outside them.
"""

import pytest
import torch

from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import decode_checks as DC
from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.ops import fused_ffn as K5
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops import int8_ffn as K1
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops import layer_step as K9
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


@pytest.mark.parametrize("B,t_actual,T,tile", [
    (1, 1500, 1500, 512), (4, 1500, 1500, 512), (8, 1400, 1500, 256),
    (32, 1500, 1500, 128), (3, 280, 300, 384)])
def test_cross_ffn_step_i8cc_kernel_matches_plain(card, B, t_actual, T, tile):
    case = DC.cross_i8cc_case(B, t_actual, T=T)
    assert case["tile"] == tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    before = (K7.launches, K7.launches_i8, K7.launches_i8cc)
    res = DC.check_cross_i8cc(case, sms)     # band, planted faults
    torch.cuda.synchronize()
    assert (K7.launches, K7.launches_i8, K7.launches_i8cc) == (
        before[0], before[1], before[2] + 1)
    assert res["faults"] >= 9


@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("pos", [0, 5, 447])
def test_layer_step_kernel_is_the_two_call_route(card, B, pos):
    case = DC.layer_case(B, pos)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    before = (K9.launches, K9.kernel_launches())
    DC.check_layer(case, sms)    # bitwise K6b → K7b; plain band; cache rows
    torch.cuda.synchronize()
    assert (K9.launches, K9.kernel_launches()) == (before[0] + 1,
                                                   before[1] + 1)


def test_int8_plane_and_layer_kernels_refuse_what_they_cannot_run(card):
    case = DC.cross_i8cc_case(2, 300, T=300)
    args, sc = case["args"], case["scales"]
    bf16 = DC.cross_ffn_case(2, 300, False, T=300)["args"]
    with pytest.raises(ValueError, match="int8 cross caches require int8"):
        K7.fused_cross_ffn_step(*bf16[:7], *args[7:], n_heads=H, **sc)
    with pytest.raises(ValueError):                   # scales one column short
        K7.fused_cross_ffn_step(*args, n_heads=H, k_scale=sc["k_scale"],
                                v_scale=sc["v_scale"][:, :-1])
    with pytest.raises(ValueError):                   # bf16 planes with scales
        K7.fused_cross_ffn_step(*args[:7], *bf16[7:], n_heads=H, **sc)
    x, blk, ck, cv, xk, xv, pos, ta = DC.layer_case(2, 3)["args"]
    plain_blk = {**blk, "self_attn": {
        **blk["self_attn"], "qkv": DC.self_attn_case(2, 3, False)["args"][2]}}
    with pytest.raises(ValueError, match="needs int8 decode weights"):
        K9.fused_layer_step(x, plain_blk, ck, cv, xk, xv, pos, ta, n_heads=H)
    with pytest.raises(ValueError):                   # pos past the cache
        K9.fused_layer_step(x, blk, ck, cv, xk, xv, S, ta, n_heads=H)
    with pytest.raises(ValueError):                   # f32 cross planes
        K9.fused_layer_step(x, blk, ck, cv, xk.float(), xv.float(), pos, ta,
                            n_heads=H)
    with pytest.raises(ValueError):                   # int8 cross planes
        K9.fused_layer_step(x, blk, ck, cv, xk.to(torch.int8),
                            xv.to(torch.int8), pos, ta, n_heads=H)
    big = K9.MAX_BATCH + 1
    with pytest.raises(ValueError):
        K9.fused_layer_step(x[:1].expand(big, D).contiguous(), blk,
                            ck[:1].expand(big, S, D).contiguous(),
                            cv[:1].expand(big, S, D).contiguous(),
                            xk[:1].expand(big, T, D).contiguous(),
                            xv[:1].expand(big, T, D).contiguous(), pos, ta,
                            n_heads=H)


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


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,bias", [(32 * 512, 768, 768, True),
                                        (32 * 77, 512, 512, True),
                                        (32 * 50, 768, 768, True),
                                        (300, 768, 768, False)])
def test_int8_dense_kernel_matches_plain(card, x_dtype, M, K, N, bias):
    before = K2.launches
    res = KC.check_int8_dense(KC.int8_dense_case(M, K, N, x_dtype, bias))
    torch.cuda.synchronize()
    assert K2.launches == before + 2 and res["fault_elements"] > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,mask,causal", [(32, 512, 12, True, False),
                                               (32, 77, 8, True, True),
                                               (32, 50, 12, False, False)])
def test_fused_attention_kernel_matches_plain(card, dtype, B, S, H, mask,
                                              causal):
    before = K3.launches
    KC.check_attention(KC.attention_case(B, S, H, mask, causal, dtype))
    torch.cuda.synchronize()
    assert K3.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_matches_plain(card, dtype):
    before = K3.ln_launches
    KC.check_layer_norm(KC.layer_norm_case(32 * 512, 768, dtype))
    torch.cuda.synchronize()
    assert K3.ln_launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,mode", [(32 * 512, 768, 3072, "tanh"),
                                        (32 * 77, 512, 2048, "quick"),
                                        (32 * 50, 768, 3072, "quick"),
                                        (4, 512, 2048, "tanh"),
                                        (32, 384, 1536, "tanh"),
                                        (32, 1024, 4096, "erf"),
                                        (32, 1280, 5120, "tanh"),
                                        (300, 1280, 5120, "tanh")])
def test_fused_ffn_kernel_matches_plain(card, dtype, M, K, N, mode):
    before = K5.launches
    KC.check_ffn(KC.ffn_case(M, K, N, mode, dtype))
    torch.cuda.synchronize()
    assert K5.launches == before + 1


def test_opt_in_kernels_refuse_what_they_cannot_run(card):
    att = KC.attention_case(2, 16, 4, True, False)
    q, k, v, m = att["q"], att["k"], att["v"], att["mask"]
    with pytest.raises(ValueError):                   # head dim 32
        K3.fused_attention(q.reshape(2, 16, 8, 32), k.reshape(2, 16, 8, 32),
                           v.reshape(2, 16, 8, 32), m)
    with pytest.raises(ValueError):                   # f16
        K3.fused_attention(q.half(), k.half(), v.half(), m)
    with pytest.raises(ValueError):                   # 513 keys
        big = torch.zeros(2, 513, 4, 64, dtype=q.dtype, device=q.device)
        K3.fused_attention(q, big, big)
    raw = torch.zeros(4 * 768 + 8, dtype=torch.bfloat16, device="cuda")
    s = torch.ones(768, device="cuda")
    with pytest.raises(ValueError):                   # misaligned pointer
        K3.fused_layer_norm(raw[1:4 * 768 + 1].view(4, 768), s, s)
    d = KC.int8_dense_case(300, 768, 768)
    with pytest.raises(ValueError):                   # f16 input
        K2.int8_dense(d["x"].half(), d["wq"], d["w_scale"], d["bias"])
    with pytest.raises(ValueError):                   # misaligned pointer
        raw = torch.zeros(300 * 768 + 8, dtype=torch.bfloat16, device="cuda")
        K2.int8_dense(raw[1:300 * 768 + 1].view(300, 768), d["wq"],
                      d["w_scale"], d["bias"])
    with pytest.raises(RuntimeError):                 # K not a multiple of 32
        K2.int8_dense(d["x"][:, :760].contiguous(), d["wq"][:760].contiguous(),
                      d["w_scale"], d["bias"])
    f = KC.ffn_case(4, 512, 2048, "tanh")["args"]
    with pytest.raises(ValueError):                   # int8 weights
        K5.fused_ffn(f[0], f[1].to(torch.int8), *f[2:])
    with pytest.raises(RuntimeError):                 # N not a multiple of 512
        K5.fused_ffn(f[0], f[1][:, :1920].contiguous(), f[2][:1920],
                     f[3][:1920].contiguous(), f[4])
