"""The port's CUDA kernels on the card. Every test here is marked
``cuda`` and skips without an NVIDIA card: a CUDA kernel has no CPU
mode. The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) The kernel is held
to its plain PyTorch version within 3 int8 levels (3·max|y|/127), and
bit for bit, which both kernel forms (split chunks at small M, one block
per row tile at large M) have shown on the card.
"""

import pytest
import torch

from misinfo_tpu_torch.ops import int8_ffn as K1
from misinfo_tpu_torch.ops.quant import quantize_dense

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
