"""The port's engine held to the JAX engine in f32 with quant="int8_ffn".

Both sides are handed ``quantize_ffn_params(tree, min_elems=1)``: the
tiny kernels sit below MIN_KERNEL_ELEMS, so the default size gate would
leave every FFN unquantized and the comparison empty. At these widths
N ≤ 512, so the chunk width equals N and the JAX CPU path
(``int8_ffn_xla``) computes the same function as the port's plain int8
FFN. Scores within 1e-3; verdicts equal wherever |fake_p − 0.5| > 1e-3.
"""

import pytest

from misinfo_tpu_torch.ops import int8_ffn as K1

from test_torch_engine import assert_close, build_engines, run_both


@pytest.fixture(scope="module")
def int8_engines(tmp_path_factory):
    return build_engines(tmp_path_factory.mktemp("vault"), "float32",
                         "int8_ffn", quantize=True)


def test_int8_ffn_batch_parity(int8_engines, monkeypatch):
    j_eng, t_eng = int8_engines
    assert "kernel_q" in t_eng.params["roberta"]["layers"][0]["mlp_in"]
    calls = []
    plain = K1.int8_ffn_plain
    monkeypatch.setattr(K1, "int8_ffn_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    a, b = run_both(j_eng, t_eng, monkeypatch)
    # full: RoBERTa 2 + CLIP text 2 + CLIP vision 2; packed text 2; visual 2
    assert len(calls) == 10
    assert_close(a, b, 1e-3)
