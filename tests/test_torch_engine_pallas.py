"""The port's engine in its opt-in kernel modes, held to the JAX engine
at DetectorConfig.tiny() in f32, both handed one tree (see
test_torch_engine.py). The JAX engine's programs trace in TPU interpret
mode, so its Pallas kernels run on the CPU; the port's wrappers take
their plain versions, whose calls are counted.

* ``use_pallas=True`` (the fused attention K3 on every unpacked row) and
  ``use_pallas="ffn"`` (the fused FFN K5 in every tower FFN): scores
  within 1e-4, verdicts equal wherever |fake_p − 0.5| > 1e-4.
* ``quant="int8"`` on ``quantize_params(tree, 1)`` with both int8 kernels
  enabled (``MISINFO_TPU_INT8_PALLAS=all``; the JAX CPU path runs the
  jitted XLA functions that its kernels are held bit-identical to): a
  batch of eight full requests gives 256 text rows per tower, so every
  RoBERTa and CLIP-text projection runs K2 (8 × 32 rows, the vision
  tower's 8 × 17 rows stay below 256); scores within 1e-3.
"""

import numpy as np
import pytest

from misinfo_tpu.ops.quant import quantize_params
from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.ops import fused_ffn as K5
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops import int8_ffn as K1

from test_torch_engine import _image, assert_close, build_engines, run_both


def _count(monkeypatch, module, name):
    calls = []
    plain = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    return calls


@pytest.mark.parametrize("use_pallas,plain,want", [
    # full: RoBERTa, CLIP text and vision, 2 layers each; packed text rows
    # keep the einsum attention (K3 on full + visual_only) but run K5
    (True, (K3, "fused_attention_plain"), 6 + 2),
    ("ffn", (K5, "fused_ffn_plain"), 6 + 2 + 2)])
def test_opt_in_kernel_modes_match_jax(use_pallas, plain, want,
                                       tmp_path, monkeypatch):
    j_eng, t_eng = build_engines(tmp_path, "float32", "none", False,
                                 use_pallas=use_pallas)
    assert t_eng.use_pallas == use_pallas
    calls = _count(monkeypatch, *plain)
    a, b = run_both(j_eng, t_eng, monkeypatch)
    assert len(calls) == want
    assert_close(a, b, 1e-4)


def test_int8_mode_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS", "all")
    j_eng, t_eng = build_engines(tmp_path, "float32", "int8",
                                 quantize_params)
    assert t_eng.quant == "int8"
    attn = t_eng.params["roberta"]["layers"][0]["attn"]["q"]
    assert "kernel_q" in attn
    k2 = _count(monkeypatch, K2, "int8_dense_plain")
    k1 = _count(monkeypatch, K1, "int8_ffn_plain")
    rng = np.random.default_rng(13)
    reqs = [{"text": " ".join(f"w{i}" for i in rng.integers(0, 999, 26)),
             "image": _image(40 + n)} for n in range(8)]
    a, b = j_eng.analyze_batch(reqs), t_eng.analyze_batch(reqs)
    assert len(k2) == 2 * 4 * 2      # RoBERTa + CLIP text, 2 layers × q/k/v/o
    assert len(k1) == 3 * 2          # every tower FFN
    assert_close(a, b, 1e-3)
    # the int8 params as the JAX engine counts them
    assert (t_eng.memory_report()["params_bytes"]
            == j_eng.memory_report()["params_bytes"])


def test_flash_refused_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="flash"):
        build_engines(tmp_path, "float32", "none", False, use_pallas="flash")
