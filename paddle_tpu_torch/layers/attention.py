"""Multi-head self-attention layer.

Port of ``paddle_tpu/layers/attention.py``: transformer-style
scaled-dot-product attention over a padded sequence [B, T, D], with the
fused projection ``_<name>.wqkv`` [D, 3·H·Dh] and the output projection
``_<name>.wo`` [H·Dh, D]. The port has no mesh, so the layer always takes
``full_attention`` (the flash kernels on the card), as the JAX layer does
when no mesh is active, whatever ``seq_parallel_mode`` says.
"""

from __future__ import annotations

from typing import List

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import (LayerContext, finalize_output, register_layer,
                                           with_seq_meta)
from paddle_tpu_torch.parallel.sequence_parallel import full_attention
from paddle_tpu_torch.proto import LayerConfig


@register_layer("multi_head_attention")
def multi_head_attention(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    arg = inputs[0]
    if not arg.is_seq or arg.value is None:
        raise ValueError(f"{cfg.name}: multi_head_attention needs a dense sequence input")
    x = arg.value                                   # [B, T, D]
    B, T, _ = x.shape
    H = max(cfg.num_heads, 1)
    Dh = cfg.size // H
    if H * Dh != cfg.size:
        raise ValueError(f"{cfg.name}: size {cfg.size} not divisible by heads {H}")
    qkv = (x @ ctx.param(f"_{cfg.name}.wqkv")).reshape(B, T, 3, H, Dh)
    # strided [B, T, H, Dh] views: the flash kernels read them as they are
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = full_attention(q, k, v, lengths=arg.seq_lengths, causal=cfg.causal_attention)
    value = out.reshape(B, T, H * Dh) @ ctx.param(f"_{cfg.name}.wo")
    mask = arg.seq_mask(dtype=value.dtype)
    value = finalize_output(cfg, value, ctx, mask=mask)
    # zero padded positions so downstream pooling and costs see clean zeros
    return with_seq_meta(arg, value * mask[..., None])
