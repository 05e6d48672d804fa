"""Reference ``.pth`` → the port's parameter tree.

Counterpart of ``misinfo_tpu/checkpoints/torch_convert.py``. It follows
the reference's checkpoint-loading contract (reference
misinfo_forensics.py:174-204, 260-317): the monolithic
``forensics_master_final.pth`` (``full_model_state_dict``) first, then the
per-branch files with their key prefixes, everything applied with
``strict=False`` semantics: tensors that match overlay the current
parameters, everything else keeps its initialization.

The converters take any mapping of key → array-like (torch tensors or
numpy arrays) and return updates as f32 numpy arrays keyed by the tree's
paths. The port's tree keeps the JAX tree's names and layouts, so the
paths and transforms are the JAX package's:

  * torch Linear [out, in] → kernel [in, out] (transpose)
  * torch Conv2d OIHW → HWIO; depthwise [C, 1, k, k] → [k, k, 1, C]
  * SE 1×1 convs → dense kernels [in, out]

``apply_updates`` writes each update as a tensor of the current leaf's
dtype on the current leaf's device. The ``export_*`` functions are the
inverse (the port's tree → the reference's key layout, f32 numpy), so that
export followed by convert gives the tree back bit for bit.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.models.efficientnet import B0_STAGES

Updates = Dict[Tuple, np.ndarray]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _linear(sd: Mapping, key: str, out: Updates, path: Tuple) -> None:
    if key + ".weight" in sd:
        out[path + ("kernel",)] = _np(sd[key + ".weight"]).T
    if key + ".bias" in sd:
        out[path + ("bias",)] = _np(sd[key + ".bias"])


def _ln(sd: Mapping, key: str, out: Updates, path: Tuple) -> None:
    if key + ".weight" in sd:
        out[path + ("scale",)] = _np(sd[key + ".weight"])
    if key + ".bias" in sd:
        out[path + ("bias",)] = _np(sd[key + ".bias"])


def _bn(sd: Mapping, key: str, out: Updates, path: Tuple) -> None:
    for tk, jk in (("weight", "scale"), ("bias", "bias"),
                   ("running_mean", "mean"), ("running_var", "var")):
        if f"{key}.{tk}" in sd:
            out[path + (jk,)] = _np(sd[f"{key}.{tk}"])


def _conv(sd: Mapping, key: str, out: Updates, path: Tuple) -> None:
    if key + ".weight" in sd:
        w = _np(sd[key + ".weight"])  # OIHW
        out[path] = w.transpose(2, 3, 1, 0)  # → HWIO ([k,k,1,C] if depthwise)


# ---------------------------------------------------------------- RoBERTa

def convert_roberta(sd: Mapping, prefix: str = "roberta.",
                    num_layers: int = 12) -> Updates:
    """HF RobertaModel state dict → updates for models.roberta's tree."""
    out: Updates = {}
    p = prefix
    for tk, path in (
        ("embeddings.word_embeddings.weight", ("embeddings", "word")),
        ("embeddings.position_embeddings.weight", ("embeddings", "position")),
        ("embeddings.token_type_embeddings.weight",
         ("embeddings", "token_type")),
    ):
        if p + tk in sd:
            out[path] = _np(sd[p + tk])
    _ln(sd, p + "embeddings.LayerNorm", out, ("embeddings", "ln"))
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}."
        base = ("layers", i)
        _linear(sd, lp + "attention.self.query", out, base + ("attn", "q"))
        _linear(sd, lp + "attention.self.key", out, base + ("attn", "k"))
        _linear(sd, lp + "attention.self.value", out, base + ("attn", "v"))
        _linear(sd, lp + "attention.output.dense", out, base + ("attn", "o"))
        _ln(sd, lp + "attention.output.LayerNorm", out, base + ("attn_ln",))
        _linear(sd, lp + "intermediate.dense", out, base + ("mlp_in",))
        _linear(sd, lp + "output.dense", out, base + ("mlp_out",))
        _ln(sd, lp + "output.LayerNorm", out, base + ("mlp_ln",))
    return out


def convert_head(sd: Mapping, prefix: str) -> Updates:
    """nn.Sequential([Linear, ReLU, Dropout, Linear]) → {fc1, fc2}, with
    full-model prefixes ('ai_head.0.weight') or prefix-stripped keys
    ('0.weight', reference misinfo_forensics.py:273)."""
    out: Updates = {}
    _linear(sd, prefix + "0", out, ("fc1",))
    _linear(sd, prefix + "3", out, ("fc2",))
    return out


def convert_fusion(sd: Mapping, prefix: str = "fusion_layer.") -> Updates:
    """nn.Sequential([Lin, ReLU, Drop, Lin, ReLU, Lin]) → {fc1, fc2, fc3}."""
    out: Updates = {}
    _linear(sd, prefix + "0", out, ("fc1",))
    _linear(sd, prefix + "3", out, ("fc2",))
    _linear(sd, prefix + "5", out, ("fc3",))
    return out


# ----------------------------------------------------------- EfficientNet

def convert_efficientnet(sd: Mapping, prefix: str = "efficientnet.") -> Updates:
    """torchvision efficientnet_b0 state dict → updates for
    models.efficientnet's tree (stage table B0_STAGES)."""
    out: Updates = {}
    p = prefix
    _conv(sd, p + "features.0.0", out, ("stem", "conv"))
    _bn(sd, p + "features.0.1", out, ("stem", "bn"))

    bi = 0  # flat block index in the tree
    for stage_idx, (e, k, s, cin, cout, n) in enumerate(B0_STAGES, start=1):
        for b in range(n):
            tb = f"{p}features.{stage_idx}.{b}.block."
            base = ("blocks", bi)
            if e != 1:
                _conv(sd, tb + "0.0", out, base + ("expand", "conv"))
                _bn(sd, tb + "0.1", out, base + ("expand", "bn"))
                dw, se, proj = "1", "2", "3"
            else:
                dw, se, proj = "0", "1", "2"
            _conv(sd, tb + dw + ".0", out, base + ("dw", "conv"))
            _bn(sd, tb + dw + ".1", out, base + ("dw", "bn"))
            for fc in ("fc1", "fc2"):
                wkey = f"{tb}{se}.{fc}.weight"
                if wkey in sd:
                    w = _np(sd[wkey])  # [out, in, 1, 1]
                    out[base + ("se", fc, "kernel")] = w[:, :, 0, 0].T
                bkey = f"{tb}{se}.{fc}.bias"
                if bkey in sd:
                    out[base + ("se", fc, "bias")] = _np(sd[bkey])
            _conv(sd, tb + proj + ".0", out, base + ("project", "conv"))
            _bn(sd, tb + proj + ".1", out, base + ("project", "bn"))
            bi += 1

    _conv(sd, p + "features.8.0", out, ("head", "conv"))
    _bn(sd, p + "features.8.1", out, ("head", "bn"))
    _linear(sd, p + "classifier.1", out, ("classifier",))
    return out


# ------------------------------------------------------------------ CLIP

def convert_clip(sd: Mapping, prefix: str = "",
                 text_layers: int = 12, vision_layers: int = 12) -> Updates:
    """HF CLIPModel state dict → updates for models.clip's tree."""
    out: Updates = {}
    p = prefix

    def blocks(tower_prefix: str, tree_name: str, n: int):
        for i in range(n):
            lp = f"{p}{tower_prefix}.encoder.layers.{i}."
            base = (tree_name, "blocks", i)
            _ln(sd, lp + "layer_norm1", out, base + ("ln1",))
            _linear(sd, lp + "self_attn.q_proj", out, base + ("attn", "q"))
            _linear(sd, lp + "self_attn.k_proj", out, base + ("attn", "k"))
            _linear(sd, lp + "self_attn.v_proj", out, base + ("attn", "v"))
            _linear(sd, lp + "self_attn.out_proj", out, base + ("attn", "o"))
            _ln(sd, lp + "layer_norm2", out, base + ("ln2",))
            _linear(sd, lp + "mlp.fc1", out, base + ("mlp_in",))
            _linear(sd, lp + "mlp.fc2", out, base + ("mlp_out",))

    for tk, path in (
        ("text_model.embeddings.token_embedding.weight",
         ("text", "token_embedding")),
        ("text_model.embeddings.position_embedding.weight",
         ("text", "position_embedding")),
        ("vision_model.embeddings.class_embedding",
         ("vision", "class_embedding")),
        ("vision_model.embeddings.position_embedding.weight",
         ("vision", "position_embedding")),
        ("logit_scale", ("logit_scale",)),
    ):
        if p + tk in sd:
            out[path] = _np(sd[p + tk])
    if p + "vision_model.embeddings.patch_embedding.weight" in sd:
        w = _np(sd[p + "vision_model.embeddings.patch_embedding.weight"])
        out[("vision", "patch_embedding")] = w.transpose(2, 3, 1, 0)
    blocks("text_model", "text", text_layers)
    blocks("vision_model", "vision", vision_layers)
    _ln(sd, p + "text_model.final_layer_norm", out, ("text", "final_ln"))
    # NB: "pre_layrnorm" is HF's actual (misspelled) parameter name
    _ln(sd, p + "vision_model.pre_layrnorm", out, ("vision", "pre_ln"))
    _ln(sd, p + "vision_model.post_layernorm", out, ("vision", "post_ln"))
    for tk, path in (("text_projection.weight", ("text_projection", "kernel")),
                     ("visual_projection.weight",
                      ("visual_projection", "kernel"))):
        if p + tk in sd:
            out[path] = _np(sd[p + tk]).T
    return out


# --------------------------------------------------------------- Whisper

def _layer_count(keys, mark: str) -> int:
    n = -1
    for k in keys:
        if k.startswith(mark):
            n = max(n, int(k[len(mark):].split(".")[0]))
    return n + 1


def convert_whisper(sd: Mapping, prefix: str = "",
                    encoder_layers: Optional[int] = None,
                    decoder_layers: Optional[int] = None) -> Updates:
    """HF WhisperModel / WhisperForConditionalGeneration state dict →
    updates for models.whisper's tree. Takes the bare model
    ('encoder.conv1.weight', …) and the conditional-generation wrapper
    ('model.encoder.…'; its tied 'proj_out' is the token embedding's
    transpose and is skipped). Layer counts come from the keys when not
    given."""
    keys = list(sd.keys())
    if not prefix and any(k.startswith("model.") for k in keys):
        prefix = "model."
    p = prefix
    enc_n = (encoder_layers if encoder_layers is not None
             else _layer_count(keys, f"{p}encoder.layers."))
    dec_n = (decoder_layers if decoder_layers is not None
             else _layer_count(keys, f"{p}decoder.layers."))

    out: Updates = {}
    for conv, path in (("conv1", ("encoder", "conv1")),
                       ("conv2", ("encoder", "conv2"))):
        wk = f"{p}encoder.{conv}.weight"
        if wk in sd:  # torch Conv1d [Cout, Cin, K] → kernel [K, Cin, Cout]
            out[path + ("kernel",)] = _np(sd[wk]).transpose(2, 1, 0)
        bk = f"{p}encoder.{conv}.bias"
        if bk in sd:
            out[path + ("bias",)] = _np(sd[bk])
    for tk, path in (
        ("encoder.embed_positions.weight", ("encoder", "positions")),
        ("decoder.embed_tokens.weight", ("decoder", "token_embedding")),
        ("decoder.embed_positions.weight", ("decoder", "positions")),
    ):
        if p + tk in sd:
            out[path] = _np(sd[p + tk])

    def block(tower: str, i: int, cross: bool):
        lp = f"{p}{tower}.layers.{i}."
        base = (tower, "blocks", i)
        _ln(sd, lp + "self_attn_layer_norm", out, base + ("ln1",))
        attn = ("self_attn",) if cross else ("attn",)
        for t, j in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                     ("out_proj", "o")):
            _linear(sd, lp + "self_attn." + t, out, base + attn + (j,))
        if cross:
            _ln(sd, lp + "encoder_attn_layer_norm", out, base + ("ln_cross",))
            for t, j in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                         ("out_proj", "o")):
                _linear(sd, lp + "encoder_attn." + t, out,
                        base + ("cross_attn", j))
        _ln(sd, lp + "final_layer_norm", out, base + ("ln2",))
        _linear(sd, lp + "fc1", out, base + ("mlp_in",))
        _linear(sd, lp + "fc2", out, base + ("mlp_out",))

    for i in range(enc_n):
        block("encoder", i, cross=False)
    for i in range(dec_n):
        block("decoder", i, cross=True)
    _ln(sd, p + "encoder.layer_norm", out, ("encoder", "final_ln"))
    _ln(sd, p + "decoder.layer_norm", out, ("decoder", "final_ln"))
    return out


_OPENAI_WHISPER_RENAMES = (
    # openai-whisper (whisper/model.py) → HF WhisperModel key fragments
    (".attn_ln.", ".self_attn_layer_norm."),
    (".attn.query.", ".self_attn.q_proj."),
    (".attn.key.", ".self_attn.k_proj."),
    (".attn.value.", ".self_attn.v_proj."),
    (".attn.out.", ".self_attn.out_proj."),
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".cross_attn.query.", ".encoder_attn.q_proj."),
    (".cross_attn.key.", ".encoder_attn.k_proj."),
    (".cross_attn.value.", ".encoder_attn.v_proj."),
    (".cross_attn.out.", ".encoder_attn.out_proj."),
    (".mlp_ln.", ".final_layer_norm."),
    (".mlp.0.", ".fc1."),
    (".mlp.2.", ".fc2."),
)


def _openai_whisper_to_hf(sd: Mapping) -> Mapping:
    """openai-whisper's native key layout (what ``whisper.load_model``
    downloads and the reference loads, forensics_dashboard.py:46-49:
    ``{tower}.blocks.N.attn.query`` …) → the HF layout that
    ``convert_whisper`` takes. HF dicts pass through unchanged."""
    if not any(k.startswith(("encoder.blocks.", "decoder.blocks."))
               for k in sd):
        return sd
    out = {}
    for k, v in sd.items():
        nk = (k.replace(".blocks.", ".layers.")
               .replace("decoder.token_embedding.weight",
                        "decoder.embed_tokens.weight")
               .replace("encoder.positional_embedding",
                        "encoder.embed_positions.weight")
               .replace("decoder.positional_embedding",
                        "decoder.embed_positions.weight")
               .replace("encoder.ln_post.", "encoder.layer_norm."))
        if nk.startswith("decoder.ln."):
            nk = "decoder.layer_norm." + nk[len("decoder.ln."):]
        # each pattern's leading '.' keeps '.attn.' from matching inside
        # '_attn.' (cross_attn), so rename order is irrelevant
        for old, new in _OPENAI_WHISPER_RENAMES:
            nk = nk.replace(old, new)
        out[nk] = v
    return out


def whisper_state_dict(path: str) -> Mapping:
    """A Whisper ``.pt``/``.pth``/``.bin`` file, HF format or openai-
    whisper's download format (``{'dims': …, 'model_state_dict': …}`` with
    ``blocks``-style keys), as an HF-layout flat state dict (unwraps
    'model_state_dict' and saved nn.Module objects)."""
    ckpt = load_pth(path)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return _openai_whisper_to_hf(sd)


def whisper_config_from_torch(sd: Mapping) -> Dict[str, int]:
    """WhisperConfig fields from a checkpoint's own tensor shapes.

    The checkpoint, not the tokenizer at hand, sets the architecture:
    building the model from a fallback tokenizer's vocab would shape-skip
    the real token embedding while every other tensor applies, a 'loaded'
    model that decodes garbage. Every Whisper size has head_dim 64, so
    num_heads follows d_model. Returns {} when the dict has no Whisper
    decoder."""
    keys = list(sd.keys())
    p = "model." if any(k.startswith("model.") for k in keys) else ""
    emb = sd.get(p + "decoder.embed_tokens.weight")
    if emb is None:
        return {}
    vocab_size, d_model = int(emb.shape[0]), int(emb.shape[1])
    out = dict(vocab_size=vocab_size, d_model=d_model,
               num_heads=max(d_model // 64, 1),
               encoder_layers=_layer_count(keys, f"{p}encoder.layers."),
               decoder_layers=_layer_count(keys, f"{p}decoder.layers."))
    conv1 = sd.get(p + "encoder.conv1.weight")
    if conv1 is not None:
        # Conv1d weight [Cout, Cin, K]; Cin = n_mels (128 in the v3 family)
        out["num_mel_bins"] = int(conv1.shape[1])
    fc1 = sd.get(p + "encoder.layers.0.fc1.weight")
    if fc1 is not None:
        out["ffn_dim"] = int(fc1.shape[0])
    enc_pos = sd.get(p + "encoder.embed_positions.weight")
    if enc_pos is not None:
        out["max_source_positions"] = int(enc_pos.shape[0])
    dec_pos = sd.get(p + "decoder.embed_positions.weight")
    if dec_pos is not None:
        out["max_target_positions"] = int(dec_pos.shape[0])
    return out


def load_whisper_from_torch(params: Dict, path: str) -> Tuple[Dict, int]:
    """An HF-format Whisper ``.pt``/``.pth``/``.bin`` overlaid on a whisper
    tree (strict=False, as every reference loader). → (params, applied)."""
    applied, _ = apply_updates(params,
                               convert_whisper(whisper_state_dict(path)))
    return params, applied


# ------------------------------------------------------------- overlay

def apply_updates(params, updates: Updates, strict: bool = False):
    """Overlay converted arrays onto a tree (strict=False semantics:
    unknown paths are skipped, shape mismatches are skipped with a note,
    as torch's load_state_dict(strict=False), which the reference uses
    everywhere, misinfo_forensics.py:182,274,282,293). Each applied leaf
    becomes a tensor of the current leaf's dtype on its device.
    → (applied, skipped [(path, reason)])."""
    applied, skipped = 0, []
    for path, value in updates.items():
        node = params
        try:
            for k in path:
                if isinstance(node, torch.Tensor):
                    raise TypeError(f"{path}: a path below a leaf")
                node, parent = node[k], node
            cur, node = node, parent
        except (KeyError, IndexError, TypeError):
            if strict:
                raise KeyError(f"no param at {path}")
            skipped.append((path, "missing"))
            continue
        shape, vshape = tuple(cur.shape), tuple(value.shape)
        if shape != vshape:
            if strict:
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{shape} vs {vshape}")
            skipped.append((path, f"shape {shape} vs {vshape}"))
            continue
        # a C-ordered copy: the kernels take contiguous weights only, and
        # a transposed array would keep its strides through the copy
        node[path[-1]] = torch.from_numpy(np.array(value, order="C")).to(
            device=cur.device, dtype=cur.dtype)
        applied += 1
    return applied, skipped


# ------------------------------------------------------------- export
# Inverse mapping: the tree → the reference's torch key layout, for
# round trips through the loading cascade and for moving weights back to
# the reference.

def _exp_linear(out: Dict, key: str, node) -> None:
    out[key + ".weight"] = _np(node["kernel"]).T
    if "bias" in node:
        out[key + ".bias"] = _np(node["bias"])


def _exp_ln(out: Dict, key: str, node) -> None:
    out[key + ".weight"] = _np(node["scale"])
    out[key + ".bias"] = _np(node["bias"])


def _exp_bn(out: Dict, key: str, node) -> None:
    for jk, tk in (("scale", "weight"), ("bias", "bias"),
                   ("mean", "running_mean"), ("var", "running_var")):
        out[f"{key}.{tk}"] = _np(node[jk])


def _exp_conv(out: Dict, key: str, kernel) -> None:
    out[key + ".weight"] = _np(kernel).transpose(3, 2, 0, 1)


def export_roberta(tree: Dict, prefix: str = "roberta.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    p = prefix
    emb = tree["embeddings"]
    out[p + "embeddings.word_embeddings.weight"] = _np(emb["word"])
    out[p + "embeddings.position_embeddings.weight"] = _np(emb["position"])
    out[p + "embeddings.token_type_embeddings.weight"] = _np(
        emb["token_type"])
    _exp_ln(out, p + "embeddings.LayerNorm", emb["ln"])
    for i, blk in enumerate(tree["layers"]):
        lp = f"{p}encoder.layer.{i}."
        _exp_linear(out, lp + "attention.self.query", blk["attn"]["q"])
        _exp_linear(out, lp + "attention.self.key", blk["attn"]["k"])
        _exp_linear(out, lp + "attention.self.value", blk["attn"]["v"])
        _exp_linear(out, lp + "attention.output.dense", blk["attn"]["o"])
        _exp_ln(out, lp + "attention.output.LayerNorm", blk["attn_ln"])
        _exp_linear(out, lp + "intermediate.dense", blk["mlp_in"])
        _exp_linear(out, lp + "output.dense", blk["mlp_out"])
        _exp_ln(out, lp + "output.LayerNorm", blk["mlp_ln"])
    return out


def export_head(tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _exp_linear(out, prefix + "0", tree["fc1"])
    _exp_linear(out, prefix + "3", tree["fc2"])
    return out


def export_fusion(tree: Dict, prefix: str = "fusion_layer."
                  ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _exp_linear(out, prefix + "0", tree["fc1"])
    _exp_linear(out, prefix + "3", tree["fc2"])
    _exp_linear(out, prefix + "5", tree["fc3"])
    return out


def export_efficientnet(tree: Dict, prefix: str = "efficientnet."
                        ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    p = prefix
    _exp_conv(out, p + "features.0.0", tree["stem"]["conv"])
    _exp_bn(out, p + "features.0.1", tree["stem"]["bn"])
    bi = 0
    for stage_idx, (e, k, s, cin, cout, n) in enumerate(B0_STAGES, start=1):
        for b in range(n):
            tb = f"{p}features.{stage_idx}.{b}.block."
            blk = tree["blocks"][bi]
            if e != 1:
                _exp_conv(out, tb + "0.0", blk["expand"]["conv"])
                _exp_bn(out, tb + "0.1", blk["expand"]["bn"])
                dw, se, proj = "1", "2", "3"
            else:
                dw, se, proj = "0", "1", "2"
            _exp_conv(out, tb + dw + ".0", blk["dw"]["conv"])
            _exp_bn(out, tb + dw + ".1", blk["dw"]["bn"])
            for fc in ("fc1", "fc2"):
                w = _np(blk["se"][fc]["kernel"]).T
                out[f"{tb}{se}.{fc}.weight"] = w[:, :, None, None]
                out[f"{tb}{se}.{fc}.bias"] = _np(blk["se"][fc]["bias"])
            _exp_conv(out, tb + proj + ".0", blk["project"]["conv"])
            _exp_bn(out, tb + proj + ".1", blk["project"]["bn"])
            bi += 1
    _exp_conv(out, p + "features.8.0", tree["head"]["conv"])
    _exp_bn(out, p + "features.8.1", tree["head"]["bn"])
    _exp_linear(out, p + "classifier.1", tree["classifier"])
    return out


def export_clip(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    p = prefix
    out[p + "text_model.embeddings.token_embedding.weight"] = _np(
        tree["text"]["token_embedding"])
    out[p + "text_model.embeddings.position_embedding.weight"] = _np(
        tree["text"]["position_embedding"])
    out[p + "vision_model.embeddings.class_embedding"] = _np(
        tree["vision"]["class_embedding"])
    out[p + "vision_model.embeddings.position_embedding.weight"] = _np(
        tree["vision"]["position_embedding"])
    out[p + "logit_scale"] = _np(tree["logit_scale"])
    out[p + "vision_model.embeddings.patch_embedding.weight"] = _np(
        tree["vision"]["patch_embedding"]).transpose(3, 2, 0, 1)

    def blocks(tower_prefix: str, tower: Dict):
        for i, blk in enumerate(tower["blocks"]):
            lp = f"{p}{tower_prefix}.encoder.layers.{i}."
            _exp_ln(out, lp + "layer_norm1", blk["ln1"])
            _exp_linear(out, lp + "self_attn.q_proj", blk["attn"]["q"])
            _exp_linear(out, lp + "self_attn.k_proj", blk["attn"]["k"])
            _exp_linear(out, lp + "self_attn.v_proj", blk["attn"]["v"])
            _exp_linear(out, lp + "self_attn.out_proj", blk["attn"]["o"])
            _exp_ln(out, lp + "layer_norm2", blk["ln2"])
            _exp_linear(out, lp + "mlp.fc1", blk["mlp_in"])
            _exp_linear(out, lp + "mlp.fc2", blk["mlp_out"])

    blocks("text_model", tree["text"])
    blocks("vision_model", tree["vision"])
    _exp_ln(out, p + "text_model.final_layer_norm", tree["text"]["final_ln"])
    _exp_ln(out, p + "vision_model.pre_layrnorm", tree["vision"]["pre_ln"])
    _exp_ln(out, p + "vision_model.post_layernorm", tree["vision"]["post_ln"])
    out[p + "text_projection.weight"] = _np(
        tree["text_projection"]["kernel"]).T
    out[p + "visual_projection.weight"] = _np(
        tree["visual_projection"]["kernel"]).T
    return out


def export_reference_state_dicts(params: Dict):
    """Detector tree → (full_sd, clip_sd) in the reference's key layout:
    ``full_sd`` is the ``full_model_state_dict`` of
    forensics_master_final.pth (roberta./ai_head./misinfo_head./
    efficientnet./fusion_layer., reference misinfo_forensics.py:181-189;
    the reference detector loads CLIP from an HF dir, so it ships
    separately as ``clip_sd`` in the clip_detective_best.pth layout)."""
    full = {}
    full.update(export_roberta(params["roberta"], "roberta."))
    full.update(export_head(params["ai_head"], "ai_head."))
    full.update(export_head(params["misinfo_head"], "misinfo_head."))
    full.update(export_efficientnet(params["efficientnet"], "efficientnet."))
    full.update(export_fusion(params["fusion"], "fusion_layer."))
    clip_sd = export_clip(params["clip"], "clip.")
    return full, clip_sd


def load_pth(path: str) -> Dict[str, Any]:
    """torch.load with the reference's settings (weights_only=False,
    reference misinfo_forensics.py:178), onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_detector_from_reference_ckpts(params: Dict, paths) -> Dict[str, Any]:
    """The reference's loading cascade (C10): the monolithic full model
    first, then the per-branch files. Overlays ``params`` in place and
    returns a report of what loaded: ``mode`` ("monolithic" or
    "individual"), ``applied``, ``skipped`` and, in monolithic mode, the
    checkpoint's ``epoch`` and ``accuracy``."""
    report: Dict[str, Any] = {"mode": None, "applied": 0, "skipped": []}

    def _overlay_full(sd):
        n = 0
        for conv, sub in (
            (lambda s: convert_roberta(s, "roberta."), "roberta"),
            (lambda s: convert_head(s, "ai_head."), "ai_head"),
            (lambda s: convert_head(s, "misinfo_head."), "misinfo_head"),
            (lambda s: convert_efficientnet(s, "efficientnet."),
             "efficientnet"),
            (lambda s: convert_fusion(s, "fusion_layer."), "fusion"),
        ):
            a, sk = apply_updates(params[sub], conv(sd))
            n += a
            report["skipped"].extend(sk)
        return n

    def _load_clip():
        # CLIP loads in BOTH modes: the reference takes its CLIP tower
        # from an HF model dir apart from the detector checkpoint
        # (misinfo_forensics.py:209-212; the monolithic
        # full_model_state_dict carries no clip.* keys)
        if os.path.exists(paths.clip_weights):
            ckpt = load_pth(paths.clip_weights)
            if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
                a, sk = apply_updates(
                    params["clip"],
                    convert_clip(ckpt["model_state_dict"], "clip."))
                report["applied"] += a
                report["skipped"].extend(sk)

    if os.path.exists(paths.fusion_weights):
        ckpt = load_pth(paths.fusion_weights)
        if isinstance(ckpt, dict) and "full_model_state_dict" in ckpt:
            report["mode"] = "monolithic"
            report["applied"] = _overlay_full(ckpt["full_model_state_dict"])
            report["epoch"] = ckpt.get("epoch")
            report["accuracy"] = ckpt.get("accuracy")
            _load_clip()
            return report

    report["mode"] = "individual"
    for attr, conv, sub in (
        ("ai_head_weights", lambda s: convert_head(s, "ai_head."), "ai_head"),
        ("misinfo_head_weights", lambda s: convert_head(s, "misinfo_head."),
         "misinfo_head"),
        ("efficientnet_weights",
         lambda s: convert_efficientnet(s, "efficientnet."), "efficientnet"),
    ):
        p = getattr(paths, attr)
        if os.path.exists(p):
            ckpt = load_pth(p)
            sd = (ckpt.get("model_state_dict", ckpt)
                  if isinstance(ckpt, dict) else ckpt)
            a, sk = apply_updates(params[sub], conv(sd))
            report["applied"] += a
            report["skipped"].extend(sk)
    _load_clip()
    return report
