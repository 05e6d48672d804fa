"""The port's reference-checkpoint loading (checkpoints/torch_convert.py)
held to the JAX package's.

- Every converter gives JAX's updates, path for path and bit for bit, on
  the same state dicts: torch modules (the heads and fusion MLP as
  tests/test_checkpoints.py builds them, tools/torch_reference.py's
  torchvision-layout EfficientNet-B0), transformers' Whisper at a tiny
  config (bare, conditional-generation and openai-whisper layouts) and
  the JAX export of a tiny detector tree (RoBERTa, CLIP).
- ``apply_updates``: JAX's applied count, ``skipped`` list and strict
  errors on unknown paths and wrong shapes; applied leaves keep the
  leaf's dtype.
- ``export_*``: equal to JAX's export of the same tree, and export
  followed by the loading cascade gives the port's tree back bit for bit.
- The Whisper transcriber from an HF torch file: JAX's config,
  ``has_weights`` and ``tokenizer_compatible``, and on a tiny model
  trained in JAX (tests/test_torch_transcript.py's recipe, at head
  dimension 64: a torch file's head count is read as d_model / 64, as
  every Whisper size has it) the same transcript as JAX's transcriber
  from the same file.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.checkpoints import torch_convert as J
from misinfo_tpu.serve import transcript as j_tr

from misinfo_tpu_torch.checkpoints import torch_convert as T
from misinfo_tpu_torch.core.config import ModelPaths
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.serve import transcript as t_tr

from tests.test_torch_transcript import TEXT, _make_audio, _write_wav


def _head():
    return torch.nn.Sequential(
        torch.nn.Linear(64, 256), torch.nn.ReLU(), torch.nn.Dropout(0.3),
        torch.nn.Linear(256, 2))


def _fusion():
    return torch.nn.Sequential(
        torch.nn.Linear(5, 64), torch.nn.ReLU(), torch.nn.Dropout(0.2),
        torch.nn.Linear(64, 32), torch.nn.ReLU(), torch.nn.Linear(32, 2))


def _prefixed(prefix, module):
    return {prefix + k: v for k, v in module.state_dict().items()}


def _tiny_whisper_config():
    from transformers import WhisperConfig
    return WhisperConfig(vocab_size=96, num_mel_bins=16, d_model=64,
                         encoder_layers=2, decoder_layers=2,
                         encoder_attention_heads=1, decoder_attention_heads=1,
                         encoder_ffn_dim=128, decoder_ffn_dim=128,
                         max_source_positions=24, max_target_positions=16,
                         pad_token_id=95, bos_token_id=94, eos_token_id=95,
                         decoder_start_token_id=94)


def _openai_layout(sd):
    """HF Whisper keys → openai-whisper's (the inverse of the port's and
    JAX's ``_openai_whisper_to_hf``)."""
    renames = [(new, old) for old, new in J._OPENAI_WHISPER_RENAMES]
    out = {}
    for k, v in sd.items():
        nk = (k.replace(".layers.", ".blocks.")
               .replace("decoder.embed_tokens.weight",
                        "decoder.token_embedding.weight")
               .replace("encoder.embed_positions.weight",
                        "encoder.positional_embedding")
               .replace("decoder.embed_positions.weight",
                        "decoder.positional_embedding")
               .replace("encoder.layer_norm.", "encoder.ln_post.")
               .replace("decoder.layer_norm.", "decoder.ln."))
        for old, new in renames:
            nk = nk.replace(old, new)
        out[nk] = v
    return out


def _state_dict(case):
    """(a state dict, the converter's name, its arguments after sd)."""
    torch.manual_seed(0)
    if case == "head":
        return _prefixed("ai_head.", _head()), "convert_head", ("ai_head.",)
    if case == "head_stripped":
        return _head().state_dict(), "convert_head", ("",)
    if case == "fusion":
        return _prefixed("fusion_layer.", _fusion()), "convert_fusion", ()
    if case == "efficientnet":
        from tools.torch_reference import TorchvisionB0
        return (_prefixed("efficientnet.", TorchvisionB0()),
                "convert_efficientnet", ())
    if case in ("roberta", "clip"):
        tree = jax.tree.map(lambda t: t.numpy(),
                            detector_init(1, DetectorConfig.tiny()))
        full, clip_sd = J.export_reference_state_dicts(tree)
        sd = {k: torch.from_numpy(v.copy()) for k, v in
              (full if case == "roberta" else clip_sd).items()}
        return sd, f"convert_{case}", (f"{case}.", 2) + (
            (2,) if case == "clip" else ())
    from transformers import WhisperForConditionalGeneration, WhisperModel
    if case == "whisper_hf":
        return WhisperModel(_tiny_whisper_config()).state_dict(), \
            "convert_whisper", ()
    if case == "whisper_generation":
        return (WhisperForConditionalGeneration(_tiny_whisper_config())
                .state_dict(), "convert_whisper", ())
    sd = WhisperModel(_tiny_whisper_config()).state_dict()
    return J._openai_whisper_to_hf(_openai_layout(sd)), "convert_whisper", ()


CASES = ["head", "head_stripped", "fusion", "efficientnet", "roberta", "clip",
         "whisper_hf", "whisper_generation", "whisper_openai"]


@pytest.mark.parametrize("case", CASES)
def test_port_converters_equal_jax(case):
    sd, name, args = _state_dict(case)
    sd = dict(sd, **{"unrelated.weight": torch.zeros(3)})
    want = getattr(J, name)(sd, *args)
    got = getattr(T, name)(sd, *args)
    assert want and sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == np.float32, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


def test_port_openai_whisper_layout_and_config_equal_jax(tmp_path):
    from transformers import WhisperModel
    sd = WhisperModel(_tiny_whisper_config()).state_dict()
    for layout in (sd, _openai_layout(sd)):
        path = str(tmp_path / "w.pt")
        torch.save({"model_state_dict": layout}, path)
        got, want = T.whisper_state_dict(path), J.whisper_state_dict(path)
        assert sorted(got) == sorted(want) == sorted(sd)
        assert T.whisper_config_from_torch(got) == \
            J.whisper_config_from_torch(want)
    assert T.whisper_config_from_torch({}) == {} == \
        J.whisper_config_from_torch({})


def test_port_apply_updates_skips_as_jax():
    det = DetectorConfig.tiny()
    port = detector_init(0, det)["fusion"]
    jaxt = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), port)
    port["fc2"]["bias"] = port["fc2"]["bias"].to(torch.bfloat16)
    rng = np.random.default_rng(0)
    updates = {("fc1", "kernel"): np.zeros((7, 7), np.float32),
               ("nonexistent", "kernel"): np.zeros((2, 2), np.float32),
               ("fc2", "bias", "x"): np.zeros((2,), np.float32),
               # a transposed view, as a converter's [out, in] → [in, out]
               ("fc3", "kernel"): rng.normal(size=(2, 32)).astype(
                   np.float32).T,
               ("fc2", "bias"): rng.normal(size=(32,)).astype(np.float32)}
    got = T.apply_updates(port, updates)
    want = J.apply_updates(jaxt, updates)
    assert got == want and got[0] == 2 and len(got[1]) == 3
    np.testing.assert_array_equal(port["fc3"]["kernel"].numpy(),
                                  np.asarray(jaxt["fc3"]["kernel"]))
    assert port["fc3"]["kernel"].is_contiguous()      # the kernels need it
    assert port["fc2"]["bias"].dtype == torch.bfloat16
    assert torch.equal(port["fc2"]["bias"], torch.from_numpy(
        updates[("fc2", "bias")]).to(torch.bfloat16))
    for bad, err in (({("nonexistent", "kernel"): np.zeros((2, 2))},
                      KeyError),
                     ({("fc1", "kernel"): np.zeros((7, 7))}, ValueError)):
        with pytest.raises(err):
            T.apply_updates(port, bad, strict=True)
        with pytest.raises(err):
            J.apply_updates(jaxt, bad, strict=True)


def _leaves(tree):
    return jax.tree.leaves(tree)


def test_port_export_equals_jax_and_round_trips(tmp_path):
    """Export of the port's tree = JAX's export of the same tree; written
    in the reference's layout and loaded through the cascade (monolithic,
    then per-branch), every leaf comes back bit for bit."""
    det = DetectorConfig.tiny()
    src = detector_init(42, det)
    full, clip_sd = T.export_reference_state_dicts(src)
    j_full, j_clip = J.export_reference_state_dicts(
        jax.tree.map(lambda t: t.numpy(), src))
    for got, want in ((full, j_full), (clip_sd, j_clip)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def tensors(sd, prefix=""):
        return {k: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith(prefix)}
    mono = ModelPaths(fusion_weights=str(tmp_path / "full.pth"),
                      clip_weights=str(tmp_path / "clip.pth"),
                      ai_head_weights=str(tmp_path / "ai.pth"),
                      misinfo_head_weights=str(tmp_path / "mis.pth"),
                      efficientnet_weights=str(tmp_path / "eff.pth"))
    torch.save({"full_model_state_dict": tensors(full), "epoch": 3,
                "accuracy": 0.5}, mono.fusion_weights)
    torch.save({"model_state_dict": tensors(clip_sd)}, mono.clip_weights)
    dst = detector_init(7, det)
    report = T.load_detector_from_reference_ckpts(dst, mono)
    assert (report["mode"], report["applied"], report["skipped"],
            report["epoch"]) == ("monolithic", len(full) + len(clip_sd),
                                 [], 3)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(src), _leaves(dst)))
    assert all(t.is_contiguous() for t in _leaves(dst))   # kernels need it

    indiv = dataclasses.replace(mono, fusion_weights=str(tmp_path / "no"))
    torch.save({"model_state_dict": tensors(full, "ai_head.")},
               indiv.ai_head_weights)
    torch.save({"model_state_dict": tensors(full, "misinfo_head.")},
               indiv.misinfo_head_weights)
    torch.save(tensors(full, "efficientnet."), indiv.efficientnet_weights)
    dst = detector_init(7, det)
    report = T.load_detector_from_reference_ckpts(dst, indiv)
    assert report["mode"] == "individual" and not report["skipped"]
    for sub in ("ai_head", "misinfo_head", "efficientnet", "clip"):
        assert all(torch.equal(a, b) for a, b in
                   zip(_leaves(src[sub]), _leaves(dst[sub]))), sub
    assert not torch.equal(src["roberta"]["embeddings"]["word"],
                           dst["roberta"]["embeddings"]["word"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny Whisper (d_model 64, one head) trained in JAX to map the
    two-tone WAV to TEXT, as tests/test_torch_transcript.py trains its
    own: (numpy tree, config, WAV path)."""
    import jax.numpy as jnp
    import optax
    from misinfo_tpu.core.config import PrecisionConfig
    from misinfo_tpu.models import whisper as jw
    from misinfo_tpu.ops.common import Policy
    from misinfo_tpu.preprocess.audio import (
        log_mel_spectrogram, pad_or_trim_mel)
    from misinfo_tpu.preprocess.whisper_tokenizer import ByteWhisperTokenizer

    f32 = Policy(PrecisionConfig.highest())
    tok = ByteWhisperTokenizer()
    sp = tok.specials
    cfg = jw.WhisperConfig(
        vocab_size=sp.vocab_size, num_mel_bins=80, d_model=64,
        encoder_layers=2, decoder_layers=2, num_heads=1, ffn_dim=128,
        max_source_positions=64, max_target_positions=32,
        eos_token_id=sp.eot, decoder_start_token_id=sp.sot)
    audio = _make_audio()
    mel = jnp.asarray(pad_or_trim_mel(log_mel_spectrogram(audio),
                                      2 * cfg.max_source_positions)[None])
    target = tok.sot_sequence() + tok.encode(TEXT) + [sp.eot]
    toks = np.full((1, cfg.max_target_positions), sp.eot, np.int32)
    toks[0, :len(target)] = target
    inp, lbl = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    weight = jnp.asarray((np.arange(cfg.max_target_positions - 1)
                          < len(target) - 1)[None].astype(np.float32))
    params = jw.whisper_init(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(3e-3)
    state = opt.init(params)

    def loss_fn(p):
        logits = jw.whisper_decode_step(
            p, inp, jw.whisper_encode(p, mel, cfg, f32), cfg, f32)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1),
                                   lbl[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * weight) / jnp.sum(weight)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, loss

    for _ in range(250):
        params, state, loss = step(params, state)
        if float(loss) < 0.01:
            break
    assert float(loss) < 0.5, f"tiny whisper failed to memorize ({loss})"
    wav = tmp_path_factory.mktemp("torch_checkpoints") / "speech.wav"
    _write_wav(wav, audio)
    return jax.tree.map(np.asarray, params), cfg, str(wav)


def _hf_file(tmp_path, params, cfg, wrapped=False):
    """The JAX-trained tiny Whisper as an HF-layout state dict file (the
    JAX package's export has no Whisper half, so the keys are built
    here, the inverse of convert_whisper)."""
    sd = {}

    def t(a):
        # C-ordered, as a torch module's state dict holds its tensors
        return torch.from_numpy(np.array(a, np.float32, order="C"))

    def lin(key, node):
        sd[key + ".weight"] = t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[key + ".bias"] = t(node["bias"])

    def ln(key, node):
        sd[key + ".weight"], sd[key + ".bias"] = t(node["scale"]), t(
            node["bias"])
    enc, dec = params["encoder"], params["decoder"]
    for c in ("conv1", "conv2"):
        sd[f"encoder.{c}.weight"] = t(np.asarray(enc[c]["kernel"])
                                      .transpose(2, 1, 0))
        sd[f"encoder.{c}.bias"] = t(enc[c]["bias"])
    sd["encoder.embed_positions.weight"] = t(enc["positions"])
    sd["decoder.embed_tokens.weight"] = t(dec["token_embedding"])
    sd["decoder.embed_positions.weight"] = t(dec["positions"])
    proj = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
            ("out_proj", "o"))
    for tower, blocks in (("encoder", enc["blocks"]),
                          ("decoder", dec["blocks"])):
        for i, b in enumerate(blocks):
            lp = f"{tower}.layers.{i}."
            ln(lp + "self_attn_layer_norm", b["ln1"])
            for hf, j in proj:
                lin(lp + "self_attn." + hf,
                    (b["attn"] if tower == "encoder" else b["self_attn"])[j])
            if tower == "decoder":
                ln(lp + "encoder_attn_layer_norm", b["ln_cross"])
                for hf, j in proj:
                    lin(lp + "encoder_attn." + hf, b["cross_attn"][j])
            ln(lp + "final_layer_norm", b["ln2"])
            lin(lp + "fc1", b["mlp_in"])
            lin(lp + "fc2", b["mlp_out"])
    ln("encoder.layer_norm", enc["final_ln"])
    ln("decoder.layer_norm", dec["final_ln"])
    if wrapped:
        sd = {"model_state_dict": {"model." + k: v for k, v in sd.items()}}
    path = str(tmp_path / ("wrapped.pt" if wrapped else "whisper.pt"))
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("wrapped", [False, True])
def test_port_transcriber_from_hf_file_matches_jax(trained, tmp_path,
                                                   wrapped):
    params, cfg, wav = trained
    path = _hf_file(tmp_path, params, cfg, wrapped)
    tr = t_tr.WhisperTranscriber(checkpoint_dir=path, device="cpu")
    jt = j_tr.WhisperTranscriber(checkpoint_dir=path)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jt.cfg)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(cfg)
    assert (tr.has_weights, tr.tokenizer_compatible) == (
        jt.has_weights, jt.tokenizer_compatible) == (True, True)
    assert tr.transcribe(wav) == jt.transcribe(wav) == TEXT
    assert all(t.is_contiguous() for t in jax.tree.leaves(tr.params))


def test_port_transcriber_file_degrades_as_jax(tmp_path):
    """A checkpoint without a usable token embedding, or a vocab other
    than the tokenizer's: JAX's has_weights, tokenizer_compatible and
    decoder ids. A directory without a native checkpoint gives no weights,
    as JAX's."""
    from transformers import WhisperModel
    sd = WhisperModel(_tiny_whisper_config()).state_dict()
    cases = {"no_embedding": {k: v for k, v in sd.items()
                              if "embed_tokens" not in k},
             "other_vocab": sd}
    for name, d in cases.items():
        path = str(tmp_path / f"{name}.pt")
        torch.save(d, path)
        tr = t_tr.WhisperTranscriber(checkpoint_dir=path, device="cpu")
        jt = j_tr.WhisperTranscriber(checkpoint_dir=path)
        assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jt.cfg), name
        assert (tr.has_weights, tr.tokenizer_compatible) == (
            jt.has_weights, jt.tokenizer_compatible), name
        assert not (tr.has_weights and tr.tokenizer_compatible), name
    tr = t_tr.WhisperTranscriber(checkpoint_dir=str(tmp_path), device="cpu")
    jt = j_tr.WhisperTranscriber(checkpoint_dir=str(tmp_path))
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jt.cfg)
    assert tr.has_weights is jt.has_weights is False
    with pytest.raises(ValueError, match="not both"):
        t_tr.WhisperTranscriber({}, checkpoint_dir=path, device="cpu")
