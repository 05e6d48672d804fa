"""k11_probe.py's scratch variants of K11's bf16 source still apply: each
step and each ablation is a text substitution on
misinfo_tpu_torch/csrc/flash_attention.cu, and a source change that
breaks one should fail here, on the CPU, not in a card call."""

import os

import pytest

import k11_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def final():
    path = os.path.join(ROOT, k11_probe.SRC, "flash_attention.cu")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("kind,names", [
    ("steps", {"a", "b", "c0"}),
    ("ablate", {"no_expf", "no_mask", "no_softmax", "no_products",
                "no_turns", "split_chains"})])
def test_probe_variants_apply_to_the_source(final, kind, names):
    variants = (k11_probe._steps(final) if kind == "steps"
                else k11_probe._ablations(final))
    assert set(variants) == names
    texts = [final, *variants.values()]
    assert len(set(texts)) == len(texts)        # each one changes something
    if kind == "steps":
        # (c0) turns the query tiles back into plain order; (b) also runs
        # one unit a block; (a) also drops the turns and the overlap
        assert "(u - bh * nq) * TQ" in variants["c0"]
        assert "const int grid = (int)units;" in variants["b"]
        assert "named_arrive(TURN_BAR, 256)" not in variants["a"]
        assert "scores(s, true, sp)" not in variants["a"]


@pytest.fixture(scope="module")
def bwd_final():
    path = os.path.join(ROOT, k11_probe.SRC, "flash_attention_bwd.cu")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("name,gone", [
    ("no_expf", "expf(__fsub_rn(x, m))"),
    ("no_elementwise", None),
    ("no_products", "wgmma_bf16"),
    ("no_turns", "TURN_BAR + c, 256")])
def test_bwd_ablations_apply_to_the_source(bwd_final, name, gone):
    """``bwd_ablate``'s variants of K11-bwd's source: each one changes the
    text, and the part it takes out is gone from the bf16 kernels."""
    variants = k11_probe._bwd_ablations(bwd_final)
    assert set(variants) == {"no_expf", "no_elementwise", "no_products",
                             "no_turns"}
    text = variants[name]
    assert text != bwd_final
    assert len(set(variants.values())) == len(variants)
    if name == "no_elementwise":
        assert "if (lim != 0x7fffffff) return;" in text
    elif name == "no_products":
        # the calls go; the header's definitions stay in wgmma_bf16.cuh
        assert "bf16w::wgmma_bf16" not in text
    else:
        assert gone not in text


def test_bwd_clocks_apply_to_the_source(bwd_final):
    """``bwd_clocks``' copy of K11-bwd's source: every part of a consumer
    step gets its clock reading, and the sums leave through bwd_clk."""
    text = k11_probe._bwd_clocks(bwd_final)
    for x in range(8):
        assert f"ck[{x}]" in text
    assert text.count("clock64()") >= 9
    assert 'extern "C" int bwd_clk_read' in text
    assert len(k11_probe.CLOCK_PARTS) == 8
