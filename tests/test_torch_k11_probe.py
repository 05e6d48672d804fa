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
