"""Attention-block definitions (port of the attention-block part of the JAX
package's ``models/blocks.py``). Residual connections live inside the
block: RMSNorm -> GQA attention -> residual -> RMSNorm -> gated MLP ->
residual."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention, mlp, norms


def _mlp_residual(params, cfg: ModelConfig, x):
    h = norms.apply(params["ln2"], x, cfg.norm_eps)
    return x + mlp.apply(params["mlp"], cfg, h)


def attn_block_apply(params, cfg: ModelConfig, x, *, positions=None,
                     segment_ids=None):
    """Training forward of one block: x [B, S, D] -> x; ``segment_ids``:
    [B, S] packed segment ids or None. (The reference also returns an
    auxiliary loss, which is 0 for this block; the port's
    ``lm.apply_train`` returns that 0 once.)"""
    h = norms.apply(params["ln1"], x, cfg.norm_eps)
    h = attention.apply(params["attn"], cfg, h, positions=positions,
                        segment_ids=segment_ids)
    return _mlp_residual(params, cfg, x + h)


def attn_block_prefill(params, cfg: ModelConfig, x, *, cache_len):
    h = norms.apply(params["ln1"], x, cfg.norm_eps)
    h, kv = attention.apply_prefill(params["attn"], cfg, h,
                                    cache_len=cache_len)
    return _mlp_residual(params, cfg, x + h), kv


def attn_block_decode(params, cfg: ModelConfig, x, k_cache, v_cache, pos):
    h = norms.apply(params["ln1"], x, cfg.norm_eps)
    h, k_cache, v_cache = attention.apply_decode(params["attn"], cfg, h,
                                                 k_cache, v_cache, pos)
    return _mlp_residual(params, cfg, x + h), k_cache, v_cache


def attn_block_decode_paged(params, cfg: ModelConfig, x, k_pool, v_pool,
                            step):
    """Paged-KV decode; ``step`` is the per-step plan shared across layers
    (see ``attention.PagedStep``)."""
    h = norms.apply(params["ln1"], x, cfg.norm_eps)
    h, k_pool, v_pool = attention.apply_decode_paged(
        params["attn"], cfg, h, k_pool, v_pool, step)
    return _mlp_residual(params, cfg, x + h), k_pool, v_pool
