"""The port's CUDA kernels on the card. Every test here is marked
``cuda`` and skips without an NVIDIA card: a CUDA kernel has no CPU
mode. The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) K1 is held to its
plain PyTorch version within 3 int8 levels (3·max|y|/127), and bit for
bit, which both kernel forms (split chunks at small M, one block per
output tile at large M) have shown on the card. K1 and K2 take int8
weights K-major only (``serving.kmajor``, as the engine stores them) and
raise on any other layout; engine I's params bytes are those of the tree
without that layout.

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
tiles, a score chunk or a V piece left out, a chunk left out of the
softmax's (m, l) merge, each piece's scale over its own rows, a piece
left out of its tile's s32 sum, the mask one row off) outside; two more
cases make the last attended row loud, so that the kernel's V piece
holding it carries its faults too. K9 (the whole-layer step) must equal K6b followed by K7b bit
for bit, output and caches, in one ``__global__`` launch per call, and
keep the band of its plain version; each case first waits for one call
on an event with a deadline, so that a grid that waits on itself fails
its test.

The int4 vault similarity kernels (K10a bf16 query, K10b int8 query) are
held to their plain versions through misinfo_tpu_torch/vault/int4_checks.py:
K10b bit for bit, K10a within (D + 1)·2^-23·Σ|q·nib|·scale per element
(the two sum orders' error bound), with planted faults (a tile or the
ragged edge left out, nibbles swapped or read unsigned, the row scale
dropped) outside that band. Through ``int4_vault_sims`` a query batch past
``MAX_BATCH`` rows goes in slices of 64, one K10b launch each, bit for
bit the concatenated per-slice results.

The detector's opt-in kernels (K2 int8 dense, K3 fused attention, K4
LayerNorm, K5 fused FFN) are held to their plain versions at the main
path's shapes through misinfo_tpu_torch/ops/kernel_checks.py: K2 bit for
bit, K3-K5 within the bands that module derives, with its planted faults
outside them. Serving's fused QKV (N = 3D): K2 bit for bit its plain
version and the three unfused launches; K3 on q, k and v cut from one
[B, S, 3·H·64] output (copied out contiguous; the strided views are
refused); the fused attention layer equal to the unfused one bit for bit
under int8, with and without K3. K11 (flash attention over segment ids,
``use_pallas="flash"``) is held to its plain version within that
module's band (the roundings of acc ± its error bound) with its planted
faults outside, on packed rows with a padding tail, the padded form,
causal rows, one key tile and S = 2,048; and at the edges of the
persistent bf16 design: B 3 × S 384 × H 5 packed and causal (a unit
count that is no multiple of the SMs, odd heads) and B 2 × S 8,192
packed (a tile list of 64 with skips); the launch with residuals gives
the same output and its l and m keep their band. K11-bwd (flash
attention's backward, csrc/flash_attention_bwd.cu) is held to its plain
version within ops/kernel_checks.py::flash_bwd_band with its planted
faults outside, fed the same residuals, at chip_smoke.py phase 33 (a)'s
shapes and B 8 × S 2,048 packed (long tile lists, many units a block);
two launches on the same inputs give the same bits; gradients through
autograd are those kernels' output bit for bit, and the no-grad path
launches no backward kernel and writes no residuals.

Head widths the kernels do not take (64 only): DetectorConfig.tiny()
under use_pallas=True and "flash" takes the einsum attention (no K3 or
K11 launch, the einsum engine's scores), and WhisperConfig.tiny()'s
widths decode unfused under the default decode config, token for token
as pallas="off" on the same int8 weights.

The host residue on the card: ``probe_link()`` returns its five keys
with positive times from pinned copies; ``nan_guard`` raises
``FloatingPointError`` on a NaN that an op leaves in a CUDA tensor,
forward and backward, and is silent outside or under ``nan_guard(False)``;
an engine on chip_smoke.py's seeded BPE assets takes the native encoder
(csrc/bpe_encoder.cpp, built by g++), and its reports equal the same
engine's on the Python encoder, non-ASCII rows included.

Training (misinfo_tpu_torch/train/): an f32 text step on the card against
the same step on the CPU at a small width (loss within 1e-4 relative, the
global gradient norm within 1e-3 relative, each leaf's gradient within
1e-3 of its largest; the attention key biases, whose exact gradient is
zero, only small on both), and bf16 trainer steps whose frozen leaves stay
``torch.equal`` to their start.
"""

import collections
import dataclasses

import pytest
import torch

from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import decode_checks as DC
from misinfo_tpu_torch.ops import flash_attention as K11
from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.ops import fused_ffn as K5
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops import int8_ffn as K1
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops import layer_step as K9
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.ops.quant import quantize_dense
from misinfo_tpu_torch.ops.serving import kmajor
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
    args = [a.cuda() for a in args]
    args[1], args[4] = kmajor(args[1]), kmajor(args[4])
    return args


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


def test_int8_kernels_refuse_n_major_weights(card):
    """K1 and K2 read the weights K-major; an [in, out] contiguous int8
    kernel (the layout the Whisper decode steps read) is refused, not
    transposed per call."""
    args = _ffn_args(300, 768, 3072)
    for i in (1, 4):
        bad = list(args)
        bad[i] = args[i].contiguous()
        with pytest.raises(ValueError, match="K-major"):
            K1.int8_ffn(*bad, mode="tanh")
    d = KC.int8_dense_case(300, 768, 768)
    with pytest.raises(ValueError, match="K-major"):
        K2.int8_dense(d["x"], d["wq"].contiguous(), d["w_scale"], d["bias"])


def test_engine_int8_params_bytes_unchanged_by_the_layout(card):
    """Engine I (quant="int8") at full width stores every int8 kernel
    K-major and no weight byte twice: its params bytes equal those of the
    same tree laid out N-major, and the storages it holds."""
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
    from misinfo_tpu_torch.ops.serving import optimize_for_serving
    cfg = ForensicsConfig(verbose=False)
    cfg = cfg.replace(precision=dataclasses.replace(cfg.precision,
                                                    quant="int8"))
    eng = MisinfoForensics(cfg, DetectorConfig(), device="cuda")
    assert eng.quant == "int8"
    n_major = optimize_for_serving(detector_init(cfg.seed, DetectorConfig()),
                                   eng.policy, "int8")     # CPU: N-major

    def leaves(t, key=None):
        if isinstance(t, dict):
            return [x for k, v in t.items() for x in leaves(v, k)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [(key, t)] if isinstance(t, torch.Tensor) else []
    got, want = leaves(eng.params), leaves(n_major)
    kq = [t for k, t in got if k == "kernel_q"]
    assert kq and all(t.t().is_contiguous() for t in kq)
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for _, t in got}
    nbytes = sum(t.numel() * t.element_size() for _, t in want)
    assert eng.memory_report()["params_bytes"] == nbytes == sum(held.values())


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,pos", [(1, 3), (4, 447), (20, 100), (1, 447),
                                   (4, 3), (32, 3), (32, 447), (1, 32),
                                   (4, 224)])
def test_self_attn_step_kernel_matches_plain(card, int8, B, pos):
    """Within the band, with every planted fault outside it: a dropped
    chunk of the kernel's split (cluster) among them."""
    case = DC.self_attn_case(B, pos, int8)
    before = (K6.launches, K6.launches_i8)
    DC.check_self_attn(case, _sms())         # output, faults, cache rows
    torch.cuda.synchronize()
    assert (K6.launches, K6.launches_i8) == (before[0] + 1,
                                             before[1] + int8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H", [6, 8, 12, 16, 20])
@pytest.mark.parametrize("B", [1, 4])
def test_self_attn_step_kernel_at_every_head_count(card, int8, H, B):
    """The cluster path at every Whisper width (tiny, base, small,
    medium, large: D = 64·H), at pos 447: clusters of the row's heads and
    chunks with the o product folded in (tiny to medium), of a head's
    chunks without (large)."""
    case = DC.self_attn_case(B, 447, int8, D=64 * H, H=H)
    _, C, fold = DC.self_split(B, H, 447, _sms(), 1 if int8 else 2)
    assert (C * H if fold else C) > 1
    before = K6.kernel_launches()
    DC.check_self_attn(case, _sms())
    torch.cuda.synchronize()
    assert K6.kernel_launches() - before == (2 if fold else 3)


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


# (B, t_actual, T, V tile, loud_last): the loud_last cases make the last
# attended row a loud V row, so that the kernel's V piece holding it
# carries planted faults (left out, and left out of its tile's s32 sum)
@pytest.mark.parametrize("B,t_actual,T,tile,loud_last", [
    pytest.param(B, ta, T, tile, False, id=f"{B}-{ta}-{T}-{tile}")
    for B, ta, T, tile in ((1, 1500, 1500, 512), (4, 1500, 1500, 512),
                           (8, 1400, 1500, 256), (32, 1500, 1500, 128),
                           (3, 280, 300, 384))] + [
    pytest.param(B, ta, T, tile, True, id=f"{B}-{ta}-{T}-{tile}-loud_last")
    for B, ta, T, tile in ((4, 1500, 1500, 512), (3, 280, 300, 384))])
def test_cross_ffn_step_i8cc_kernel_matches_plain(card, B, t_actual, T, tile,
                                                  loud_last):
    case = DC.cross_i8cc_case(B, t_actual, T=T, loud_last=loud_last)
    assert case["tile"] == tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    before = (K7.launches, K7.launches_i8, K7.launches_i8cc)
    res = DC.check_cross_i8cc(case, sms)     # band, planted faults
    torch.cuda.synchronize()
    assert (K7.launches, K7.launches_i8, K7.launches_i8cc) == (
        before[0], before[1], before[2] + 1)
    assert res["faults"] >= 34


def _layer_step_finishes(case, seconds=30.0):
    """One K9 call on clones of the case's caches, waited for on a CUDA
    event polled for at most ``seconds``: a grid that waits on itself
    fails here instead of stalling the run."""
    import time
    x, blk, ck, cv, xk, xv, pos, ta = case["args"]
    K9.fused_layer_step(x, blk, ck.clone(), cv.clone(), xk, xv, pos, ta,
                        n_heads=case["n_heads"])
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            pytest.fail(f"layer_step B={x.shape[0]} pos={pos} did not finish "
                        f"in {seconds} s")
        time.sleep(0.01)


def _check_layer_step(B, pos, H=8):
    case = DC.layer_case(B, pos, D=64 * H, H=H)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _layer_step_finishes(case)
    before = (K9.launches, K9.kernel_launches())
    DC.check_layer(case, sms)    # bitwise K6b → K7b; plain band; cache rows
    torch.cuda.synchronize()
    assert (K9.launches, K9.kernel_launches()) == (before[0] + 1,
                                                   before[1] + 1)


@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("pos", [0, 5, 447])
def test_layer_step_kernel_is_the_two_call_route(card, B, pos):
    """B = 32, pos 447 gives more (row, head, chunk) virtual blocks than
    B = 1 and 4 and one chunk a head; B ≤ 4 from pos 64 two chunks a head
    that wait for each other."""
    _check_layer_step(B, pos)


@pytest.mark.parametrize("B,pos,H", [(4, 200, 8), (1, 64, 8), (20, 100, 8),
                                     (8, 447, 8), (1, 447, 12),
                                     (2, 447, 20)])
def test_layer_step_kernel_at_the_design_edges(card, B, pos, H):
    """Chunks of unequal length (pos 200: 101 and 100 rows; pos 64: 33 and
    32), one chunk a head with B·H past the SM count (B = 20), two chunks a
    head over 128 virtual blocks (B = 8), all with the o1 product folded
    in; Whisper small (H = 12), whose seven chunks a head leave the o1
    product a phase of its own; Whisper large (H = 20), four chunks a head
    and the o1 product folded in at 16 columns a chunk."""
    _check_layer_step(B, pos, H)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 4, 32])
def test_decode_step_kernels_global_launches(card, int8, B):
    """By the libraries' own counts: K6 two ``__global__`` launches per
    call at whisper-base where the o product is folded into the attention
    (B = 1, 4), three where it is not (B = 32), K7 five (from eleven), K8
    five (from nine)."""
    sc, cc = DC.self_attn_case(B, 447, int8), DC.cross_ffn_case(B, T, int8)
    fold = DC.self_split(B, H, 447, _sms(), 1 if int8 else 2)[2]
    before = (K6.kernel_launches(), K7.kernel_launches())
    K6.fused_self_attn_step(*sc["args"], n_heads=H)
    K7.fused_cross_ffn_step(*cc["args"], n_heads=H)
    torch.cuda.synchronize()
    assert (K6.kernel_launches() - before[0],
            K7.kernel_launches() - before[1]) == (2 if fold else 3, 5)
    if int8:
        ic = DC.cross_i8cc_case(B, T)
        before = K7.kernel_launches_i8cc()
        K7.fused_cross_ffn_step(*ic["args"], n_heads=H, **ic["scales"])
        torch.cuda.synchronize()
        assert K7.kernel_launches_i8cc() - before == 5


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


@pytest.mark.parametrize("B,N,D", [
    (B, N, 512) for N in (K10.INT4_TILE_ROWS * 3, 5000 + 77, (1 << 17) - 1)
    for B in (1, 3, 32, 64)] + [
    (B, 5000 + 77, D) for D in (160, 256, 768, 1024) for B in (3, 64)])
def test_int4_sims_kernels_match_plain(card, B, N, D):
    """1-64 query rows (one to eight n-tiles) against aligned and ragged
    vaults: 5,077 and 131,071 rows end in a partial tile, and 131,071 is
    odd (the sims rows are not 16-byte aligned). Past 512 dims the tiles
    are of 64 rows; 160 dims (a partial 64-byte slice) and 256 dims are
    both sides of K10a's chained steps, and each width runs K10b at 3 and
    64 query rows (its 32-row and 16-row warps up to 512 dims)."""
    packed, scale = IC.vault_case(N, d=D, seed=N, device=card)
    q = IC.query_case(B, d=D, seed=B, device=card)
    before = (K10.launches, K10.launches_i8)
    res = IC.check_k10a(q, packed, scale)          # band, planted faults
    IC.check_k10b(q, packed, scale)                # bit for bit
    torch.cuda.synchronize()
    assert res["faults"] == (7 if N % IC.tiles(B, D)[0] else 6)
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


@pytest.mark.parametrize("B", [65, 130, 192])
def test_int4_vault_sims_splits_query_batches_past_max_batch(card, B):
    """A query batch past MAX_BATCH goes through K10b in consecutive
    slices of at most 64 rows, ceil(B / 64) launches, and gives the
    concatenated results of the per-slice calls bit for bit (every row is
    independent, its query quantized per row). 192 rows are one video
    program's frames at V = 16, F = 12."""
    packed, scale = IC.vault_case(K10.KERNEL_MIN_ROWS, device=card)
    q = IC.query_case(B, seed=B, device=card)
    before = (K10.launches, K10.launches_i8)
    got = K10.int4_vault_sims(q, packed, scale)
    torch.cuda.synchronize()
    assert (K10.launches - before[0], K10.launches_i8 - before[1]) == (
        0, -(-B // K10.MAX_BATCH))
    want = torch.cat([K10.int4_sims_i8(q[lo:lo + K10.MAX_BATCH], packed,
                                       scale)
                      for lo in range(0, B, K10.MAX_BATCH)])
    assert torch.equal(got, want)
    assert torch.equal(got, K10.int4_sims_i8_plain(q, packed, scale))


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
@pytest.mark.parametrize("B,S,H,layout,causal", [
    (32, 512, 12, "packed", False), (32, 512, 12, "padded", False),
    (32, 512, 12, "packed", True), (32, 128, 12, "packed", False),
    (8, 2048, 12, "packed", False), (4, 256, 12, "none", True),
    (3, 384, 5, "packed", True), (2, 8192, 12, "packed", False)])
def test_flash_attention_kernel_matches_plain(card, dtype, B, S, H, layout,
                                              causal):
    before = K11.launches
    KC.check_flash(KC.flash_case(B, S, H, layout, causal, dtype))
    torch.cuda.synchronize()
    assert K11.launches == before + 2         # without and with residuals


# chip_smoke.py phase 33 (a): the training shape (B 16 × S 256 packed),
# RoBERTa b32/S512 packed, padded (its last row all padding) and packed
# causal, one key tile (S = 128), and B 3 × S 384 × H 5 packed causal
FLASH_BWD_SHAPES = [(16, 256, 12, "packed", False),
                    (32, 512, 12, "packed", False),
                    (32, 512, 12, "padded", False),
                    (32, 512, 12, "packed", True),
                    (32, 128, 12, "packed", False),
                    (3, 384, 5, "packed", True),
                    (8, 2048, 12, "packed", False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,layout,causal", FLASH_BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain(card, dtype, B, S, H,
                                                  layout, causal):
    before = (K11.bwd_dkv_launches, K11.bwd_dq_launches)
    KC.check_flash_bwd(KC.flash_bwd_case(B, S, H, layout, causal, dtype))
    torch.cuda.synchronize()
    assert (K11.bwd_dkv_launches, K11.bwd_dq_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,layout,causal", [
    (32, 512, 12, "packed", False), (32, 512, 12, "padded", False),
    (3, 384, 5, "packed", True), (8, 2048, 12, "packed", False)])
def test_flash_attention_bwd_kernels_repeat_bit_for_bit(card, dtype, B, S, H,
                                                        layout, causal):
    """No atomics: each output tile has one owner that sums its terms in
    one fixed order, so two launches on the same inputs give the same
    bits."""
    c = KC.flash_bwd_case(B, S, H, layout, causal, dtype)
    args = (c["q"], c["k"], c["v"], c["q_seg"], c["kv_seg"], c["l"], c["m"],
            c["do"], K11.flash_di(c["o"], c["do"]), causal)
    first = (*K11.flash_dkv(*args), K11.flash_dq(*args))
    again = (*K11.flash_dkv(*args), K11.flash_dq(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_grads_are_the_bwd_kernels(card, dtype,
                                                   monkeypatch):
    """Through autograd the forward launches K11 with residuals once and
    the backward each K11-bwd kernel once, with the kernels' output bit for
    bit; without grad (or under no_grad) the bare launch runs, with no
    residuals and no backward kernel."""
    c = KC.flash_bwd_case(2, 256, 4, "packed", True, dtype)
    q, k, v, qs, ks = (c[n] for n in ("q", "k", "v", "q_seg", "kv_seg"))
    calls = []
    launch = K11._launch
    monkeypatch.setattr(K11, "_launch", lambda *a, **kw: calls.append(
        kw.get("residuals", False)) or launch(*a, **kw))
    counts = (K11.bwd_dkv_launches, K11.bwd_dq_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = K11.flash_attention(*leaves, qs, ks, True)
    grads = torch.autograd.grad(out, leaves, c["do"])
    o, l, m = K11.flash_forward(q, k, v, qs, ks, True)
    want = K11.flash_attention_bwd(q, k, v, qs, ks, o, l, m, c["do"], True)
    torch.cuda.synchronize()
    assert torch.equal(out, o)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert calls == [True, True]
    assert (K11.bwd_dkv_launches, K11.bwd_dq_launches) == (
        counts[0] + 2, counts[1] + 2)
    calls.clear()
    K11.flash_attention(q, k, v, qs, ks, True)
    with torch.no_grad():
        K11.flash_attention(*leaves, qs, ks, True)
    torch.cuda.synchronize()
    assert calls == [False, False]
    assert (K11.bwd_dkv_launches, K11.bwd_dq_launches) == (
        counts[0] + 2, counts[1] + 2)
    with pytest.raises(NotImplementedError):          # a second derivative
        out = K11.flash_attention(*leaves, qs, ks, True)
        torch.autograd.grad(out, leaves[0], c["do"], create_graph=True)


def test_flash_attention_bwd_kernel_refuses_what_it_cannot_run(card):
    c = KC.flash_bwd_case(2, 256, 4, "packed", False)
    args = [c[n] for n in ("q", "k", "v", "q_seg", "kv_seg", "o", "l", "m",
                           "do")]
    with pytest.raises(ValueError):                   # f16
        K11.flash_attention_bwd(*(t.half() if t.is_floating_point()
                                  and t.dim() == 4 else t for t in args))
    with pytest.raises(ValueError):                   # l in bf16
        K11.flash_attention_bwd(*args[:6], args[6].bfloat16(), *args[7:])
    with pytest.raises(ValueError):                   # l on [B, S, H]
        K11.flash_attention_bwd(*args[:6], args[6].transpose(1, 2)
                                .contiguous(), *args[7:])
    with pytest.raises(ValueError):                   # int64 segment ids
        K11.flash_attention_bwd(*args[:3], args[3].long(), args[4].long(),
                                *args[5:])


def test_flash_attention_kernel_refuses_what_it_cannot_run(card):
    c = KC.flash_case(2, 256, 4, "packed", False)
    q, k, v, qs, ks = (c[n] for n in ("q", "k", "v", "q_seg", "kv_seg"))
    with pytest.raises(ValueError):                   # head dim 32
        K11.flash_attention(q.reshape(2, 256, 8, 32), k.reshape(2, 256, 8, 32),
                            v.reshape(2, 256, 8, 32), qs, ks)
    with pytest.raises(ValueError):                   # f16
        K11.flash_attention(q.half(), k.half(), v.half(), qs, ks)
    with pytest.raises(ValueError):                   # 200 queries
        K11.flash_attention(q[:, :200].contiguous(), k, v)
    with pytest.raises(ValueError):                   # int64 segment ids
        K11.flash_attention(q, k, v, qs.long(), ks.long())
    with pytest.raises(ValueError):                   # strided q
        K11.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, qs, ks)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(32 * 512, 768, 3 * 768),
                                   (32 * 77, 512, 3 * 512),
                                   (32 * 50, 768, 3 * 768)])
def test_int8_dense_kernel_at_the_fused_qkv_widths(card, x_dtype, M, K, N):
    """K2 at N = 3D (serving's fused QKV: RoBERTa, CLIP text, CLIP
    vision at b32): bit for bit its plain version, and the one launch
    equal to the three unfused launches."""
    before = K2.launches
    res = KC.check_int8_dense_fused(KC.int8_dense_case(M, K, N, x_dtype))
    torch.cuda.synchronize()
    assert K2.launches == before + 2 + 2 * 4 and res["fault_elements"] > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,mask,causal", [(32, 512, 12, True, False),
                                               (32, 77, 8, True, True)])
def test_fused_attention_kernel_on_split_fused_qkv(card, dtype, B, S, H,
                                                   mask, causal):
    """K3 on q, k, v cut from one [B, S, 3·H·64] product output as the
    fused attention layer cuts them (each third copied out contiguous):
    within its band of the plain version. The strided views themselves
    are refused."""
    case = KC.attention_case(B, S, H, mask, causal, dtype)
    qkv = torch.cat([case[n].reshape(B, S, -1) for n in "qkv"], dim=-1)
    views = [t.reshape(B, S, H, 64) for t in qkv.split(H * 64, dim=-1)]
    with pytest.raises(ValueError, match="contiguous"):
        K3.fused_attention(*views, mask=case["mask"], causal=causal)
    for n, t in zip("qkv", views):
        case[n] = t.contiguous()
    before = K3.launches
    KC.check_attention(case)
    torch.cuda.synchronize()
    assert K3.launches == before + 1


def test_fused_qkv_attention_on_the_card(card):
    """multi_head_attention on a fused int8 dict at RoBERTa's width, b32
    × 512: equal bit for bit to the unfused dict, with the kernel (K2 one
    launch for qkv and one for o, against four) and through K3."""
    from misinfo_tpu_torch.ops.attention import multi_head_attention
    from misinfo_tpu_torch.ops.common import Policy
    from misinfo_tpu_torch.ops.serving import (
        fuse_qkv_params, optimize_for_serving)
    gen = torch.Generator().manual_seed(15)
    attn = {n: {"kernel": torch.randn(768, 768, generator=gen) * 0.03,
                "bias": torch.randn(768, generator=gen) * 0.01}
            for n in "qkvo"}
    x = torch.randn(32, 512, 768, generator=gen).to(torch.bfloat16).cuda()
    mask = (torch.arange(512)[None] < torch.tensor([512 - 7 * b for b in
                                                    range(32)])[:, None])
    mask = mask.float().cuda()
    pol = Policy()
    out = {}
    for fuse in (False, True):
        p = optimize_for_serving(
            {n: {k: t.cuda() for k, t in d.items()} for n, d in attn.items()},
            pol, quant="int8", fuse=fuse)
        assert ("qkv" in p) == fuse and p["o"]["kernel_q"].t().is_contiguous()
        for pallas in (False, True):
            k2, k3 = K2.launches, K3.launches
            out[fuse, pallas] = multi_head_attention(
                p, x, 12, mask=mask, policy=pol, use_pallas=pallas)
            torch.cuda.synchronize()
            assert K2.launches - k2 == (2 if fuse else 4)
            assert K3.launches - k3 == int(pallas)
    assert torch.equal(out[True, False], out[False, False])
    assert torch.equal(out[True, True], out[False, True])
    assert fuse_qkv_params(attn)["qkv"]["kernel"].shape == (768, 2304)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,causal", [(77, True), (77, False), (200, True)])
def test_fused_attention_kernel_on_a_padding_row(card, dtype, S, causal):
    """A batch row whose keys are all masked (bucket padding) still has
    the plain version's softmax over −1e9 + s; with causal masking the
    kernel must then walk the tiles it otherwise skips."""
    case = KC.attention_case(3, S, 4, True, causal, dtype, seed=1)
    case["mask"][1] = 0.0
    before = K3.launches
    KC.check_attention(case)
    torch.cuda.synchronize()
    assert K3.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,D", [(32 * 512, 768), (4096, 512),
                                    (4096, 1280), (4096, 1000), (333, 1001),
                                    (5, 1024)])
def test_layer_norm_kernel_matches_plain(card, dtype, rows, D):
    """The compiled row widths (512, 768, 1024, 1280) and the general loop
    (1,000; 1,001, whose bf16 rows are not 16-byte aligned), fewer rows
    than warps among them."""
    before = K3.ln_launches
    KC.check_layer_norm(KC.layer_norm_case(rows, D, dtype))
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
                                        (300, 1280, 5120, "tanh"),
                                        (37, 768, 3072, "tanh"),
                                        (32 * 512 - 1, 768, 3072, "tanh"),
                                        (1, 512, 2048, "tanh")])
def test_fused_ffn_kernel_matches_plain(card, dtype, M, K, N, mode):
    """The main path's shapes, the Whisper decode widths, and ragged row
    counts (37: a split down product over one 64-row tile; 16,383: the
    128 × 256 tiles with a ragged last row tile; 1: one decode row)."""
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
    with pytest.raises(RuntimeError):                 # K not a multiple of 16
        K2.int8_dense(d["x"][:, :760].contiguous(), kmajor(d["wq"][:760]),
                      d["w_scale"], d["bias"])
    f = KC.ffn_case(4, 512, 2048, "tanh")["args"]
    with pytest.raises(ValueError):                   # int8 weights
        K5.fused_ffn(f[0], f[1].to(torch.int8), *f[2:])
    with pytest.raises(RuntimeError):                 # N not a multiple of 8
        K5.fused_ffn(f[0], f[1][:, :1916].contiguous(), f[2][:1916],
                     f[3][:1916].contiguous(), f[4])


# ------------------------------------------------------------ CUDA graphs
# Each engine mode on a small detector (head dim 64, weights just past
# the serving quantization's size floor, so that the int8 kernels run),
# and each vault row type, IVF and the device resize: a graphed
# engine (the default) and an eager one
# (cuda_graphs=False) on the same weights and vault; every request mix
# after a full-grid warmup is dispatched under sync debug "error", its
# packed outputs torch.equal to eager's, in shuffled order, with the same
# kernel launches per replay as per eager run, and no new runner.

def _small_det():
    from misinfo_tpu_torch.models.clip import ClipConfig
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.models.roberta import RobertaConfig
    return DetectorConfig(
        roberta=RobertaConfig(vocab_size=1024, hidden_size=512, num_layers=2,
                              num_heads=8, intermediate_size=1024,
                              max_position_embeddings=130),
        clip=ClipConfig(vocab_size=512, text_width=512, text_layers=2,
                        text_heads=8, text_mlp=1024, max_text_len=32,
                        eos_token_id=511, image_size=64, patch_size=16,
                        vision_width=512, vision_layers=2, vision_heads=8,
                        vision_mlp=1024, projection_dim=64))


_GRAPH_MODES = {
    "default": ({}, {}, {}),
    "engine_I": ({"quant": "int8"}, {"use_pallas": True}, {}),
    "engine_II": ({"quant": "none"}, {"use_pallas": "ffn"}, {}),
    "int4": ({}, {}, {"vault_dtype": "int4"}),
    "int4_small": ({}, {}, {"vault_dtype": "int4"}),
    "bf16_vault": ({}, {}, {"vault_dtype": "bfloat16"}),
    "int8_vault": ({}, {}, {"vault_dtype": "int8"}),
    "ivf": ({}, {}, {"vault_ivf": True}),
    "device_resize": ({}, {}, {"device_resize": True,
                               "image_staging_buckets": (96, 160)}),
}
# the counters (ops/graphs.py::launch_counts) of each mode's own kernels,
# of which the traffic must launch each
_MODE_KERNELS = {"engine_I": ("int8_dense.launches",
                              "fused_attention.launches"),
                 "engine_II": ("fused_ffn.launches",),
                 "int4": ("int4.launches_i8",),
                 "int4_small": ("int4.launches",)}


def _graph_vault(path, rows, seed):
    import numpy as np
    from misinfo_tpu_torch.vault.store import TruthVault
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(rows, 64)).astype(np.float32)
    TruthVault(emb, [{"title": f"t{i}", "url": "u", "date": "d"}
                     for i in range(rows)],
               rng.normal(size=(rows, 64)).astype(np.float32)).save(path)
    return path


def _graph_engines(tmp_path, mode):
    from misinfo_tpu_torch.core import config as C
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import detector_init
    prec, kw, serving = _GRAPH_MODES[mode]
    rows = 65536 if mode == "int4" else 300
    paths = [_graph_vault(str(tmp_path / f"v{i}.npz"), rows + 64 * i, i)
             for i in range(2)]
    det = _small_det()
    cfg = C.ForensicsConfig(
        verbose=False,
        precision=dataclasses.replace(C.PrecisionConfig(), **prec),
        paths=C.ModelPaths(vault_path=paths[0]),
        seq=C.SequenceConfig(roberta_max_len=128, image_size=64),
        serving=dataclasses.replace(
            C.ServingConfig(batch_buckets=(1, 2, 4, 8),
                            video_batch_buckets=(1, 2)), **serving))
    params = detector_init(0, det)
    return [MisinfoForensics(cfg, det, params=params, device="cuda",
                             cuda_graphs=g, **kw)
            for g in (True, False)], paths


def _graph_traffic():
    import numpy as np

    def img(seed):
        return np.random.default_rng(seed).integers(0, 256, (64 + seed, 80,
                                                             3), np.uint8)
    short, mid = "a short claim", "a medium claim about some news " * 3
    long = "many words " * 30
    return [
        [{"text": short}],
        [{"text": long}, {"text": short}, {"text": mid}],
        [{"text": f"{short} {i}"} for i in range(5)],
        [{"text": mid} for _ in range(9)] + [{"text": short}],
        [{"image": img(1)}, {"image": img(2)}, {"image": img(3)}],
        [{"text": short, "image": img(4)}, {"text": long, "image": img(5)}],
        [{"text": short}, {"image": img(6)}, {"text": mid, "image": img(7)},
         {"text": long}, {"text": short, "image": img(8)}],
        [{"video": "clip0", "text": mid}, {"video": "clip1"}],
        [{"video": "clip2", "text": short}, {"video": "clip3", "text": long}],
    ]


def _seeded_frames(monkeypatch):
    import numpy as np
    from misinfo_tpu_torch.engine import forensics as F

    def sample(key, max_frames=12, stride_seconds=1.0, fps_fallback=25.0):
        i = int(key[-1])
        frames = [np.random.default_rng(40 + 100 * i + f).integers(
            0, 256, (72, 96, 3), np.uint8) for f in range(5 + i)]
        valid = np.zeros((max_frames,), bool)
        valid[:len(frames)] = True
        return frames, valid
    monkeypatch.setattr(F, "sample_video_frames", sample)


def _bits(a, b):
    """Bit for bit: the packed outputs carry int32 indices viewed as f32
    (-1, a NaN pattern), which torch.equal on the floats would refuse."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _dispatch(eng, reqs, debug=None):
    """The packed outputs of one dispatch (copied to the host after it),
    and the kernels' launches it made."""
    from misinfo_tpu_torch.ops import graphs
    before = graphs.launch_counts()
    if debug:
        torch.cuda.set_sync_debug_mode(debug)
    try:
        outs = [o for _, o, _ in eng._dispatch_batch(reqs)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [o.cpu() for o in outs], graphs.counts_since(before)


@pytest.mark.parametrize("mode", list(_GRAPH_MODES))
def test_graph_replays_equal_eager(card, tmp_path, monkeypatch, mode):
    import random
    _seeded_frames(monkeypatch)
    (graphed, eager), paths = _graph_engines(tmp_path, mode)
    sigs = graphed.warmup(full_grid=True)
    assert sigs and len(graphed._runners) == len(sigs)
    assert all(r.graph is not None for r in graphed._runners.values())
    traffic = _graph_traffic()
    order = list(range(len(traffic)))
    random.Random(mode).shuffle(order)
    total = collections.Counter()
    for i in order:
        want, w_launch = _dispatch(eager, traffic[i])
        got, g_launch = _dispatch(graphed, traffic[i], debug="error")
        assert len(got) == len(want), i
        assert all(_bits(a, b) for a, b in zip(got, want)), i
        assert g_launch == w_launch, (i, g_launch, w_launch)
        assert len(graphed._runners) == len(sigs), i
        total.update(w_launch)
    assert total["int8_ffn.launches"] > 0 or mode == "engine_II"      # K1
    assert all(total[k] > 0 for k in _MODE_KERNELS.get(mode, ())), total
    # two batches of one signature in flight
    a, b = traffic[3][:8], traffic[3][2:] + traffic[3][:2]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fa = graphed.analyze_batch_async(a)
        fb = graphed.analyze_batch_async(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fa() == eager.analyze_batch(a) and fb() == eager.analyze_batch(b)
    # a new vault: the warmed signatures re-captured, the rest dropped
    for eng in (graphed, eager):
        eng.reload_vault(paths[1])
    assert list(graphed._runners) == sigs
    for i in order[::-1]:
        want, _ = _dispatch(eager, traffic[i])
        got, _ = _dispatch(graphed, traffic[i], debug="error")
        assert all(_bits(x, y) for x, y in zip(got, want)), i


def test_per_stream_scratch_does_not_grow_under_capture(card):
    from misinfo_tpu_torch.ops import cuda_build
    dev = torch.device("cuda", 0)
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        h = s.cuda_stream
        small = cuda_build.workspace(1024, dev, h)
        g = torch.cuda.CUDAGraph()
        g.capture_begin()
        try:
            assert cuda_build.workspace(512, dev, h) is small
            with pytest.raises(RuntimeError, match="capture"):
                cuda_build.workspace(1 << 20, dev, h)
        finally:
            g.capture_end()
        big = cuda_build.workspace(1 << 20, dev, h)
    assert big is not small
    assert any(t is small for t in cuda_build._RETIRED)


@pytest.mark.parametrize("quant", ["auto", "embedding", "int8"])
def test_transcriber_graphs_equal_eager(card, quant):
    import numpy as np
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import graphs
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    tok = ByteWhisperTokenizer()
    sp = tok.specials
    cfg = W.WhisperConfig(vocab_size=sp.vocab_size, d_model=384,
                          encoder_layers=2, decoder_layers=2, num_heads=6,
                          ffn_dim=1536, max_target_positions=40,
                          eos_token_id=sp.eot, decoder_start_token_id=sp.sot)
    def numpy_tree(t):
        if isinstance(t, dict):
            return {k: numpy_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [numpy_tree(v) for v in t]
        return t.numpy()
    tree = numpy_tree(W.whisper_init(7, cfg))
    dc = WhisperDecodeConfig(language="en", quant=quant)
    tg, te = (WhisperTranscriber(tree, config=cfg, device="cuda",
                                 decode_cfg=dc, cuda_graphs=g)
              for g in (True, False))
    assert tg.pallas == (quant != "int8")        # int8: the streaming step
    assert tg.quant_kernels == (quant == "auto")
    assert tg.warmup((1, 2)) == [1, 2]
    mels = np.random.default_rng(0).standard_normal(
        (2, 3000, 80)).astype(np.float32)
    with torch.inference_mode():
        for b in (1, 2, 34):
            prompt = torch.tensor([tok.sot_sequence(language="en")[1:]] * b,
                                  device="cuda")
            if b <= 2:
                enc_g, enc_e = tg._encode(mels[:b]), te._encode(mels[:b])
                assert torch.equal(enc_g, enc_e)
            else:   # past MAX_BATCH: the unfused step, captured alike
                enc_g = enc_e = torch.randn(
                    b, 1500, 384, generator=torch.Generator().manual_seed(b)
                ).to("cuda", torch.bfloat16)
                tg._decode(enc_g, prompt)          # captured at first use
                tg._decode(enc_g, prompt, 0.5, 7)
            for t, seed in ((0.0, None), (0.5, 7), (1.0, 11), (0.0, None)):
                before = graphs.launch_counts()
                e = te._decode(enc_e, prompt, t, seed)
                eager = graphs.counts_since(before)
                before = graphs.launch_counts()
                g = tg._decode(enc_g, prompt, t, seed)
                assert all(torch.equal(x, y) for x, y in zip(g, e)), (b, t)
                assert graphs.counts_since(before) == eager, (b, t)


# ------------------------------------------------- reference checkpoints
# The reference .pth cascade on the card: the small detector's seeded tree
# written through export_reference_state_dicts (monolithic, or the
# per-branch files), an engine booted from the files beside one given the
# tree it must hold; their reports equal float for float, and the booted
# engine behind the API answers as itself.

@pytest.mark.parametrize("layout", ["monolithic", "individual"])
def test_engine_booted_from_reference_pth_equals_the_tree(card, tmp_path,
                                                          monkeypatch,
                                                          layout):
    import json
    import urllib.request

    import numpy as np
    from misinfo_tpu_torch.checkpoints.torch_convert import (
        export_reference_state_dicts)
    from misinfo_tpu_torch.core import config as C
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import detector_init
    from misinfo_tpu_torch.serve.api import ForensicsAPI, serve

    det = _small_det()
    tree = detector_init(3, det)
    full, clip_sd = export_reference_state_dicts(tree)

    def tensors(sd, prefix=""):
        return {k: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith(prefix)}
    if layout == "monolithic":
        torch.save({"full_model_state_dict": tensors(full), "epoch": 8,
                    "accuracy": 0.9538},
                   tmp_path / "forensics_master_final.pth")
        torch.save({"model_state_dict": tensors(clip_sd)},
                   tmp_path / "clip_detective_best.pth")
        want_tree, written = tree, len(full) + len(clip_sd)
    else:
        torch.save({"model_state_dict": tensors(full, "ai_head.")},
                   tmp_path / "ai_head_best.pth")
        torch.save({"model_state_dict": tensors(full, "misinfo_head.")},
                   tmp_path / "roberta_detective_best.pth")
        torch.save(tensors(full, "efficientnet."),
                   tmp_path / "efficientnet_cifake_best.pth")
        want_tree = detector_init(C.ForensicsConfig().seed, det)
        for sub in ("ai_head", "misinfo_head", "efficientnet"):
            want_tree[sub] = tree[sub]
        written = sum(len(tensors(full, p)) for p in
                      ("ai_head.", "misinfo_head.", "efficientnet."))
    monkeypatch.chdir(tmp_path)
    cfg = C.ForensicsConfig(
        verbose=False,
        paths=C.ModelPaths(vault_path=_graph_vault(
            str(tmp_path / "v.npz"), 300, 0)),
        seq=C.SequenceConfig(roberta_max_len=128, image_size=64))
    booted = MisinfoForensics(cfg, det, device="cuda")
    assert (booted.load_report["mode"], booted.load_report["applied"],
            booted.load_report["skipped"]) == (layout, written, [])
    given = MisinfoForensics(cfg, det, params=want_tree, device="cuda",
                             cuda_graphs=False)
    reqs = [r for group in _graph_traffic()[:7] for r in group]
    assert booted.analyze_batch(reqs) == given.analyze_batch(reqs)

    api = ForensicsAPI(engine=booted)
    httpd = serve(api, port=0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["device"] == torch.cuda.get_device_name(0)
        assert health["checkpoint_mode"] == layout
        req = urllib.request.Request(
            url + "/analyze", data=json.dumps({"text": "a claim"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        want = given.analyze_batch([{"text": "a claim"}],
                                   explanations=True)[0]
        assert got["verdict"] == want["verdict"]
        assert np.isclose(got["scores"]["fake_probability"],
                          want["scores"]["fake_probability"], atol=1e-6)
    finally:
        httpd.shutdown()
        api.close()


# ----------------------------------------------------------------- training
# the trainers' steps on the card: autograd through the bf16 products'
# f32-accumulating backward (ops/common.py::_MatmulF32) and cuDNN's
# convolutions, the in-place AdamW update, the freeze masks

def _text_grads(tree, det, policy, batch, device):
    """(loss, the trainable leaves' gradients) of one misinfo-head text
    step on ``device``, captured at the optimizer."""
    from misinfo_tpu_torch.train import optim, steps
    from misinfo_tpu_torch.utils.tree import clone_tree

    class Capture:
        def update(self, grads, state):
            self.grads = [g.detach().float().cpu() for g in grads]
    tree = clone_tree(tree, device)
    tx = optim.make_optimizer(optim.OptimConfig(), optim.branch_mask(
        tree, ["roberta", "misinfo_head"]))
    state = tx.init(tree)
    cap = Capture()
    step = steps.make_text_head_step(cap, det, policy)
    _, _, m = step(tree, state, steps.batch_to(batch, device))
    return float(m["loss"]), dict(zip(state.paths, cap.grads))


def test_train_f32_text_step_card_matches_cpu(card):
    import numpy as np
    from misinfo_tpu_torch.core.config import PrecisionConfig
    from misinfo_tpu_torch.models.detector import detector_init
    from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
    det = _small_det()
    det = dataclasses.replace(det, roberta=dataclasses.replace(
        det.roberta, hidden_dropout=0.0))
    set_exact_f32(parity=True)
    policy = Policy(PrecisionConfig.highest())
    tree = detector_init(5, det)
    tree = {k: tree[k] for k in ("roberta", "ai_head", "misinfo_head")}
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0
    ids[1, 40:] = 1
    batch = {"input_ids": ids, "attention_mask": mask,
             "labels": np.asarray([0, 1], np.int32)}
    l_cpu, g_cpu = _text_grads(tree, det, policy, batch, "cpu")
    l_card, g_card = _text_grads(tree, det, policy, batch, card)
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    n_cpu = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in g_cpu.values()]))
    n_card = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in g_card.values()]))
    assert abs(n_card - n_cpu) <= 1e-3 * n_cpu
    top = max(float(g.abs().max()) for g in g_cpu.values())
    for path, a in g_cpu.items():
        b = g_card[path]
        if path[-2:] == ("k", "bias"):
            assert max(float(a.abs().max()), float(b.abs().max())) <= (
                1e-5 * top), path
            continue
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max()), \
            path


@pytest.mark.parametrize("kind", ["text", "effnet", "clip"])
def test_train_bf16_step_leaves_frozen_leaves_equal(card, kind):
    import numpy as np
    from misinfo_tpu_torch.core.config import PrecisionConfig
    from misinfo_tpu_torch.models.detector import detector_init
    from misinfo_tpu_torch.ops.common import Policy
    from misinfo_tpu_torch.train import optim, steps
    from misinfo_tpu_torch.train.clip_detective import clip_trainable_mask
    from misinfo_tpu_torch.utils.tree import clone_tree, leaves_with_paths
    det = _small_det()
    policy = Policy(PrecisionConfig(compute_dtype="bfloat16",
                                    gelu_mode="erf"))
    start = detector_init(6, det)
    tree = clone_tree(start, card)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    if kind == "text":
        mask = optim.branch_mask(tree, ["roberta", "misinfo_head"])
        step_fn = steps.make_text_head_step
        batch = {"input_ids": rng.integers(3, 1000, (8, 64)).astype(np.int32),
                 "attention_mask": np.ones((8, 64), np.int32)}
    elif kind == "effnet":
        mask = optim.branch_mask(tree, ["efficientnet"])
        batch = {"images_u8": imgs}
    else:
        mask = clip_trainable_mask(tree)
        ids = rng.integers(1, 500, (8, 16)).astype(np.int32)
        ids[:, -1] = det.clip.eos_token_id
        batch = {"input_ids": ids, "attention_mask": np.ones((8, 16),
                                                             np.int32),
                 "images_u8": imgs}
    batch["labels"] = np.asarray([0, 1] * 4, np.int32)
    tx = optim.make_optimizer(optim.OptimConfig(lr=1e-3, total_steps=4,
                                                warmup_fraction=0.0), mask)
    state = tx.init(tree)
    step = {"text": lambda: steps.make_text_head_step(tx, det, policy),
            "effnet": lambda: steps.make_effnet_step(tx, policy),
            "clip": lambda: steps.make_clip_step(tx, det, policy)}[kind]()
    gen = torch.Generator(card).manual_seed(0)
    losses = []
    for _ in range(3):
        tree, state, m = step(tree, state, steps.batch_to(batch, card), gen)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    train = dict(leaves_with_paths(mask))
    moved = 0
    for (path, a), (_, b) in zip(leaves_with_paths(start),
                                 leaves_with_paths(tree)):
        b = b.cpu()
        if not train[path]:
            assert torch.equal(a, b), path
        else:
            moved += not torch.equal(a, b)
            assert b.dtype == torch.float32
    assert moved > 0


# ------------------------------------- head widths the kernels do not take
# DetectorConfig.tiny() has RoBERTa heads of 16 and CLIP heads of 16 and 24,
# WhisperConfig.tiny() four heads of 16; every kernel of the attention and
# the decode step takes heads of 64 only.

@pytest.mark.parametrize("use_pallas,quant", [(True, "int8"),
                                              ("flash", "none")])
def test_tiny_detector_attention_takes_the_einsum_path(card, tmp_path,
                                                       use_pallas, quant):
    """DetectorConfig.tiny() under use_pallas=True (engine I's mode, int8)
    and "flash" (engine III's) on the card: every attention takes the
    einsum path (ops/attention.py::_kernel_route), so the reports are the
    einsum engine's in the same quant mode, scores within 1e-4, with no K3
    or K11 launch (both used to raise ValueError on these widths)."""
    from misinfo_tpu_torch.core import config as C
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import (DetectorConfig,
                                                   detector_init)
    det = DetectorConfig.tiny()
    cfg = C.ForensicsConfig(
        verbose=False,
        precision=dataclasses.replace(C.PrecisionConfig(), quant=quant),
        paths=C.ModelPaths(vault_path=_graph_vault(
            str(tmp_path / "v.npz"), 300, 0)),
        seq=C.SequenceConfig(roberta_max_len=128, image_size=64))
    params = detector_init(0, det)
    eng, einsum = (MisinfoForensics(cfg, det, params=params, device="cuda",
                                    cuda_graphs=False, use_pallas=p)
                   for p in (use_pallas, False))
    reqs = [r for group in _graph_traffic()[:7] for r in group]
    reqs += [{"text": "many words about a claim " * 40}]  # RoBERTa's 128
    before = (K3.launches, K11.launches)
    got = eng.analyze_batch(reqs)
    torch.cuda.synchronize()
    assert (K3.launches, K11.launches) == before
    want = einsum.analyze_batch(reqs)
    drift = max(abs(a["scores"][k] - b["scores"][k])
                for a, b in zip(got, want) for k in a["scores"]
                if isinstance(a["scores"][k], float))
    assert drift <= 1e-4


def test_tiny_transcriber_decodes_unfused(card):
    """WhisperConfig.tiny()'s widths (four heads of 16) under the default
    decode config on the card: pallas resolves on and quant to "kernels"
    (int8 decoder weights), but no window batch takes the fused step, whose
    kernels take heads of 64 only; the tokens equal those of pallas="off"
    on the same int8 weights (quant="kernels"), token for token, greedy
    and sampled, and no decode-step kernel launches."""
    import numpy as np
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    tok = ByteWhisperTokenizer()
    sp = tok.specials
    cfg = dataclasses.replace(
        W.WhisperConfig.tiny(), vocab_size=sp.vocab_size, num_mel_bins=80,
        max_source_positions=1500, max_target_positions=40,
        eos_token_id=sp.eot, decoder_start_token_id=sp.sot)

    def numpy_tree(t):
        if isinstance(t, dict):
            return {k: numpy_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [numpy_tree(v) for v in t]
        return t.numpy()
    tree = numpy_tree(W.whisper_init(7, cfg))
    dc = WhisperDecodeConfig(language="en")
    tr, off = (WhisperTranscriber(tree, config=cfg, device="cuda",
                                  decode_cfg=d, cuda_graphs=False)
               for d in (dc, dataclasses.replace(dc, pallas="off",
                                                 quant="kernels")))
    assert (tr.pallas, tr.quant_kernels) == (True, True)
    assert (off.pallas, off.quant_kernels) == (False, True)
    mels = np.random.default_rng(0).standard_normal(
        (2, 3000, 80)).astype(np.float32)
    counters = (K6.launches, K6.launches_i8, K7.launches, K7.launches_i8)
    with torch.inference_mode():
        for b in (1, 2):
            enc = tr._encode(mels[:b])
            assert torch.equal(enc, off._encode(mels[:b]))
            assert not tr._fused(enc)
            prompt = torch.tensor([tok.sot_sequence(language="en")[1:]] * b,
                                  device="cuda")
            for t, seed in ((0.0, None), (0.5, 7)):
                got = tr._decode(enc, prompt, t, seed)
                want = off._decode(enc, prompt, t, seed)
                assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert (tr._decode_window_batch(mels, "en")
                == off._decode_window_batch(mels, "en"))
    torch.cuda.synchronize()
    assert (K6.launches, K6.launches_i8, K7.launches,
            K7.launches_i8) == counters


# ---------------------------------------------------------- host residue
# The link probe on the card, nan_guard on CUDA tensors, and the native
# BPE encoder (csrc/bpe_encoder.cpp, built by g++) through a card engine.

def test_probe_link_on_the_card(card, monkeypatch):
    from misinfo_tpu_torch.preprocess import hostprobe
    monkeypatch.setattr(hostprobe, "_link_cache", None)
    link = hostprobe.probe_link(iters=4)
    assert set(link) == {"platform", "staging", "staged_h2d_ms_per_image",
                         "crops_h2d_ms_per_image", "delta_ms_per_image"}
    assert link["platform"] == "cuda" and link["staging"] == 640
    assert link["staged_h2d_ms_per_image"] > 0
    assert link["crops_h2d_ms_per_image"] > 0
    assert hostprobe.probe_link() is link                # cached


def test_nan_guard_on_cuda_tensors(card):
    from misinfo_tpu_torch.utils.tracing import nan_guard
    x = torch.tensor([-1.0, 4.0], device=card)
    assert torch.isnan(torch.log(x)).any()               # silent outside
    with nan_guard():
        torch.sqrt(x[1:])
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
        with nan_guard(False):
            torch.log(x)
    w = torch.zeros(2, device=card, requires_grad=True)
    with nan_guard(), pytest.raises(FloatingPointError):
        (torch.sqrt(w) * 0).sum().backward()             # 0 · inf
    assert not torch.is_anomaly_enabled()


def test_native_encoder_through_a_card_engine(card, tmp_path):
    import chip_smoke
    from misinfo_tpu_torch.core import config as C
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import detector_init
    from misinfo_tpu_torch.preprocess.native_bpe import NativeRobertaTokenizer
    from misinfo_tpu_torch.preprocess.tokenizer import RobertaTokenizer
    det = _small_det()
    assets, words = chip_smoke.seeded_bpe_assets(
        str(tmp_path / "bpe"), n_vocab=det.roberta.vocab_size)
    cfg = C.ForensicsConfig(
        verbose=False,
        paths=C.ModelPaths(vault_path=_graph_vault(str(tmp_path / "v.npz"),
                                                   300, 0),
                           roberta_tokenizer_dir=assets),
        seq=C.SequenceConfig(roberta_max_len=128, image_size=64))
    eng = MisinfoForensics(cfg, det, params=detector_init(0, det),
                           device="cuda", cuda_graphs=False)
    tok = eng.roberta_tokenizer
    assert isinstance(tok, NativeRobertaTokenizer) and tok.native_available
    import numpy as np
    image = np.random.default_rng(1).integers(0, 256, (64, 64, 3), np.uint8)
    reqs = [{"text": t, "image": image}
            for t in chip_smoke.corpus_texts(3, words, 8, 60,
                                             non_ascii_every=3)]
    native = eng.analyze_batch(reqs)
    eng.roberta_tokenizer = RobertaTokenizer(*(f"{assets}/{n}" for n in
                                               ("vocab.json", "merges.txt")))
    assert eng.analyze_batch(reqs) == native
