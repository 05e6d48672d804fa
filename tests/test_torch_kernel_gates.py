"""The rules that keep the port's kernels off shapes they do not take, as
pure functions of the shape (this image has no card):

* the transcriber's fused decode step (serve/transcript.py::_fused_step):
  at most MAX_BATCH window rows and 64-wide heads; the tiny config (four
  heads of 16) decodes unfused, as JAX's ``use_pallas`` sends it to its XLA
  path;
* the attention engines (ops/attention.py::_kernel_route): K11 and K3 take
  64-wide heads on a CUDA tensor and any width on the CPU (their plain
  versions), so a 16- or 24-wide head on the card takes the einsum path.
"""

import pytest

from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.whisper import WhisperConfig
from misinfo_tpu_torch.ops import attention
from misinfo_tpu_torch.ops.self_attn_step import HEAD_DIM, MAX_BATCH
from misinfo_tpu_torch.serve import transcript


@pytest.mark.parametrize("cfg,batch,fused", [
    (WhisperConfig.tiny(), 1, False),
    (WhisperConfig.tiny(), MAX_BATCH, False),
    (WhisperConfig(), 1, True),
    (WhisperConfig(), MAX_BATCH, True),
    (WhisperConfig(), MAX_BATCH + 1, False)])
def test_fused_decode_step_rule(cfg, batch, fused):
    assert transcript._fused_step(cfg, batch) is fused


def test_every_whisper_size_has_the_kernels_heads():
    base = WhisperConfig()
    assert (base.d_model, base.num_heads) == (512, 8)
    assert base.d_model == base.num_heads * HEAD_DIM
    tiny = WhisperConfig.tiny()
    assert tiny.d_model // tiny.num_heads == 16


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("use_pallas", [True, "flash"])
@pytest.mark.parametrize("hd", [16, 24, 64])
def test_attention_kernel_route(hd, use_pallas, device):
    kernel = "flash" if use_pallas == "flash" else "fused"
    want = "einsum" if device == "cuda" and hd != 64 else kernel
    # RoBERTa's packed rows: flash only; below JAX's flash gate K3 takes
    # unpacked rows and the einsum path packed ones
    assert attention._kernel_route(use_pallas, 128, 128, hd, device,
                                   False) == want
    packed = "einsum" if use_pallas is True else want
    assert attention._kernel_route(use_pallas, 128, 128, hd, device,
                                   True) == packed
    below = "einsum" if device == "cuda" and hd != 64 else "fused"
    assert attention._kernel_route(use_pallas, 77, 77, hd, device,
                                   False) == below
    assert attention._kernel_route(use_pallas, 77, 77, hd, device,
                                   True) == "einsum"
    assert attention._kernel_route(False, 128, 128, hd, device,
                                   False) == "einsum"


def test_tiny_detector_heads_take_the_einsum_path_on_the_card():
    """DetectorConfig.tiny(): RoBERTa heads of 16, CLIP heads of 16 and 24;
    under use_pallas=True and "flash" on the card every one of them takes
    the einsum path (none is 64 wide)."""
    det = DetectorConfig.tiny()
    widths = {det.roberta.hidden_size // det.roberta.num_heads,
              det.clip.text_width // det.clip.text_heads,
              det.clip.vision_width // det.clip.vision_heads}
    assert widths == {16, 24}
    for hd in widths:
        for use_pallas in (True, "flash"):
            assert attention._kernel_route(use_pallas, 128, 128, hd, "cuda",
                                           False) == "einsum"
