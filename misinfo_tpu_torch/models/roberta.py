"""RoBERTa-base encoder + dual classification heads.

Counterpart of ``misinfo_tpu/models/roberta.py``: post-LN encoder blocks,
RoBERTa position ids (cumsum(mask)·mask + padding_idx), additive padding
mask, CLS pooling into the ``ai_head`` / ``misinfo_head`` MLPs
(768→256→ReLU→256→2). The packed path takes explicit ``position_ids``
and ``segment_ids`` (block-diagonal attention). Int8-quantized FFNs run
through the fused int8 FFN (ops/int8_ffn.py); ``use_pallas="ffn"`` runs
the other FFNs through the fused FFN kernel (ops/fused_ffn.py) and keeps
the einsum attention, ``use_pallas=True`` the fused attention kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from misinfo_tpu_torch.ops.attention import attention_init, multi_head_attention
from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, dense_init, gelu, layer_norm,
    layer_norm_init)
from misinfo_tpu_torch.ops.fused_ffn import ffn_apply
from misinfo_tpu_torch.ops.int8_ffn import int8_ffn_apply


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    head_hidden: int = 256
    head_dropout: float = 0.3

    @staticmethod
    def tiny() -> "RobertaConfig":
        return RobertaConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                             num_heads=4, intermediate_size=128,
                             max_position_embeddings=130)


def head_init(gen: torch.Generator, cfg: RobertaConfig) -> Dict:
    return {"fc1": dense_init(gen, cfg.hidden_size, cfg.head_hidden),
            "fc2": dense_init(gen, cfg.head_hidden, 2)}


def head_apply(params: Dict, pooled: torch.Tensor,
               policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """Linear → ReLU → Linear (inference: dropout is the identity)."""
    h = torch.relu(dense(params["fc1"], pooled, policy))
    return dense(params["fc2"], h, policy).float()


def roberta_init(gen: torch.Generator,
                 cfg: RobertaConfig = RobertaConfig()) -> Dict:
    d = cfg.hidden_size
    return {
        "embeddings": {
            "word": torch.randn(cfg.vocab_size, d, generator=gen) * 0.02,
            "position": torch.randn(cfg.max_position_embeddings, d,
                                    generator=gen) * 0.02,
            "token_type": torch.zeros(cfg.type_vocab_size, d),
            "ln": layer_norm_init(d),
        },
        "layers": [{
            "attn": attention_init(gen, d),
            "attn_ln": layer_norm_init(d),
            "mlp_in": dense_init(gen, d, cfg.intermediate_size),
            "mlp_out": dense_init(gen, cfg.intermediate_size, d),
            "mlp_ln": layer_norm_init(d),
        } for _ in range(cfg.num_layers)],
    }


def _position_ids(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    mask = (input_ids != pad_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_id


def roberta_encode(
    params: Dict,
    input_ids: torch.Tensor,        # [B, S] int
    attention_mask: torch.Tensor,   # [B, S] int
    cfg: RobertaConfig = RobertaConfig(),
    policy: Policy = DEFAULT_POLICY,
    *,
    use_pallas=False,
    position_ids: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """→ last_hidden_state [B, S, D] in the compute dtype."""
    emb = params["embeddings"]
    pos_ids = (position_ids if position_ids is not None
               else _position_ids(input_ids, cfg.pad_token_id))
    x = (emb["word"][input_ids.long()] + emb["position"][pos_ids.long()]
         + emb["token_type"][0])
    x = layer_norm(emb["ln"], x, cfg.layer_norm_eps, policy)
    ffn_fused = use_pallas == "ffn"
    attn_pallas = False if ffn_fused else use_pallas
    for layer in params["layers"]:
        attn_out = multi_head_attention(
            layer["attn"], x, cfg.num_heads,
            mask=None if segment_ids is not None else attention_mask,
            segment_ids=segment_ids, policy=policy, use_pallas=attn_pallas)
        x = layer_norm(layer["attn_ln"], x + attn_out, cfg.layer_norm_eps,
                       policy)
        if "kernel_q" in layer["mlp_in"]:
            mlp = int8_ffn_apply(layer["mlp_in"], layer["mlp_out"], x,
                                 policy=policy, mode=policy.gelu_mode)
        elif ffn_fused:
            mlp = ffn_apply(layer["mlp_in"], layer["mlp_out"], x,
                            policy=policy, mode=policy.gelu_mode)
        else:
            mlp = dense(layer["mlp_out"],
                        gelu(dense(layer["mlp_in"], x, policy), policy),
                        policy)
        x = layer_norm(layer["mlp_ln"], x + mlp, cfg.layer_norm_eps, policy)
    return x


def dual_head_logits(
    backbone_params: Dict,
    ai_head_params: Dict,
    misinfo_head_params: Dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: RobertaConfig = RobertaConfig(),
    policy: Policy = DEFAULT_POLICY,
    use_pallas=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLS pooling into both heads → (ai_logits [B,2], misinfo_logits [B,2])
    in f32."""
    pooled = roberta_encode(backbone_params, input_ids, attention_mask,
                            cfg, policy, use_pallas=use_pallas)[:, 0, :]
    return (head_apply(ai_head_params, pooled, policy),
            head_apply(misinfo_head_params, pooled, policy))
