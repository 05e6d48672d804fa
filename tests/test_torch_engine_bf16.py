"""The port's engine held to the JAX engine in bf16 serving mode with
quant="int8_ffn" (both sides handed ``quantize_ffn_params(tree, 1)``).
bf16 rounds in other places in the two frameworks, so scores are held
within 0.05, the bf16 band of tests/test_serving_opt.py."""

import pytest

from test_torch_engine import SCORES, build_engines, run_both


@pytest.fixture(scope="module")
def bf16_engines(tmp_path_factory):
    return build_engines(tmp_path_factory.mktemp("vault"), "bfloat16",
                         "int8_ffn", quantize=True)


def test_bf16_int8_ffn_batch_within_band(bf16_engines, monkeypatch):
    j_eng, t_eng = bf16_engines
    assert t_eng.policy.gelu_mode == "tanh"
    a, b = run_both(j_eng, t_eng, monkeypatch)
    for ra, rb in zip(a, b):
        for k in SCORES:
            assert abs(ra["scores"][k] - rb["scores"][k]) < 0.05, k
