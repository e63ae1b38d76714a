"""GQA/MHA attention layer with RoPE, optional QKV bias and KV caching
(port of the JAX package's ``attention.py``: the training forward, prefill,
dense-cache decode and paged-pool decode). The training forward runs the
flash kernels (``ops.flash_attention``) and the dense decode the dense
decode kernel (``ops.decode_attention``) unless ``cfg.use_pallas ==
"never"``; the paged decode always runs the paged kernel, and prefill the
plain ``chunked_attention``.

The caches and pools are updated in place (JAX returns new arrays); the
functions still return them, so call sites read like the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import attention_core as core
from repro_torch.models.layers.rope import (apply_rope, rotary_angles,
                                            rotary_dims)


def _head_mask(cfg: ModelConfig, dtype, device):
    """Padded q heads (``pad_heads_to``) are zero-masked at the attention
    output, so the padded model is exactly the unpadded one."""
    hp = cfg.padded_heads
    if hp == cfg.num_heads:
        return None
    keep = torch.arange(hp, device=device) < cfg.num_heads
    return keep.to(dtype)[None, None, :, None]


def _hmap(cfg: ModelConfig) -> np.ndarray:
    rep = max(1, cfg.num_heads // cfg.num_kv_heads)
    return np.minimum(np.arange(cfg.padded_heads) // rep,
                      cfg.num_kv_heads - 1)


def _project(x, w, bias=None):
    """einsum("bsd,dhk->bshk") (+ bias [h, k]) as one matrix product."""
    b, s, d = x.shape
    x2, w2 = x.reshape(b * s, d), w.reshape(d, -1)
    y = x2 @ w2 if bias is None else torch.addmm(bias.reshape(-1), x2, w2)
    return y.view(b, s, *w.shape[1:])


def _project_qkv(params, cfg: ModelConfig, x, positions, angles=None):
    bias = cfg.attn_bias
    q = _project(x, params["wq"], params["bq"] if bias else None)
    k = _project(x, params["wk"], params["bk"] if bias else None)
    v = _project(x, params["wv"], params["bv"] if bias else None)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor,
                   angles)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor,
                   angles)
    return q, k, v


def _out_proj(params, cfg: ModelConfig, out, dtype):
    out = out.to(dtype)
    hm = _head_mask(cfg, out.dtype, out.device)
    if hm is not None:
        out = out * hm
    b, s, h, dh = out.shape
    return out.reshape(b, s, h * dh) @ params["wo"].reshape(h * dh, -1)


def apply(params: dict, cfg: ModelConfig, x, *, positions=None,
          segment_ids=None):
    """Training forward (causal). x: [B, S, D] -> [B, S, D]. ``positions``:
    [S] or [B, S] RoPE positions (default arange(S); packed batches pass
    per-segment-reset positions). ``segment_ids``: [B, S] int32 packed
    segment ids (0 = pad): attention is block-diagonal over equal ids.

    Attention goes through ``ops.flash_attention`` (the CUDA kernels of
    rows 4-6 on the card, their plain versions on the CPU) unless
    ``cfg.use_pallas == "never"``, which keeps the reference's
    ``chunked_attention``, as the reference's ``ops`` documents its kernels
    behind that switch. The reference's vision prefix (``prefix_len``) is
    not ported."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cfg.use_pallas == "never":
        out = core.chunked_attention(q, k, v, hmap=_hmap(cfg), causal=True,
                                     softcap=cfg.attn_logit_softcap,
                                     segment_ids=segment_ids)
    else:
        out = ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            _hmap_tensor(cfg, x.device), causal=True,
            segment_ids=segment_ids, softcap=cfg.attn_logit_softcap)
    return _out_proj(params, cfg, out, x.dtype)


def apply_prefill(params, cfg: ModelConfig, x, *, cache_len: int = 0):
    """Causal prefill. x: [B, S, D] -> (out [B, S, D], (k, v)) with k/v
    [B, max(S, cache_len), KVH, Dh], zero past S."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = core.chunked_attention(q, k, v, hmap=_hmap(cfg), causal=True,
                                 softcap=cfg.attn_logit_softcap)
    out = _out_proj(params, cfg, out, x.dtype)
    if cache_len and cache_len > s:
        pad = (0, 0, 0, 0, 0, cache_len - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return out, (k, v)


@dataclass
class DenseStep:
    """Per-decode-step plan shared by every layer's dense-cache write and
    attention call (the counterpart of ``PagedStep``): the write positions
    and the kernel's small operands, built once per step on the device."""

    rows: torch.Tensor       # [B] long row ids
    pos: torch.Tensor        # [B] long write position (may be past the cache)
    at: torch.Tensor         # [B] long write position clamped into the cache
    inside: torch.Tensor     # [B, 1, 1] bool: the write lands in the cache
    valid_len: torch.Tensor  # [B] int32 = pos + 1
    hmap: torch.Tensor       # [H] int32 q-head -> kv-head map
    angles: tuple            # RoPE (cos, sin) [B, 1, rot/2] of the positions


def dense_step(cfg: ModelConfig, pos, max_len: int) -> DenseStep:
    """``pos``: per-row [B] write positions on the device; ``max_len``: the
    cache length."""
    dev = pos.device
    pos = pos.long()
    return DenseStep(
        rows=torch.arange(pos.shape[0], device=dev), pos=pos,
        at=pos.clamp(max=max_len - 1),
        inside=(pos < max_len)[:, None, None],
        valid_len=(pos + 1).to(torch.int32), hmap=_hmap_tensor(cfg, dev),
        angles=rotary_angles(pos[:, None], rotary_dims(
            cfg.head_dim, cfg.partial_rotary_factor), cfg.rope_theta))


def apply_decode(params, cfg: ModelConfig, x, k_cache, v_cache,
                 step: DenseStep):
    """One-token decode against a dense cache. x: [B, 1, D]; caches
    [B, Smax, KVH, Dh] (one layer's slice); ``step``: the step's plan from
    ``dense_step``, shared by every layer. Rows whose pos is past the cache
    (finished slots riding along) drop their write, as JAX's out-of-bounds
    scatter does. Attention goes through ``ops.decode_attention`` (the CUDA
    kernel of row 3 on the card, its plain version on the CPU) unless
    ``cfg.use_pallas == "never"``, which takes ``core.decode_attention``
    (that plain version, on any device). Returns (out [B, 1, D], k_cache,
    v_cache)."""
    q, k, v = _project_qkv(params, cfg, x, step.pos[:, None], step.angles)
    # each row writes only its own cache row, so the clamped write-back of
    # the old value for a dropped row cannot collide with another row
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[step.rows, step.at] = torch.where(
            step.inside, new[:, 0].to(cache.dtype),
            cache[step.rows, step.at])
    if cfg.use_pallas == "never":
        out = core.decode_attention(q, k_cache, v_cache, step.valid_len,
                                    hmap=step.hmap,
                                    softcap=cfg.attn_logit_softcap)
    else:
        out = ops.decode_attention(q.contiguous(), k_cache, v_cache,
                                   step.valid_len, step.hmap,
                                   softcap=cfg.attn_logit_softcap)
    return _out_proj(params, cfg, out, x.dtype), k_cache, v_cache


@dataclass
class PagedStep:
    """Per-decode-step plan shared by every layer's paged write and kernel
    call: where each row's new K/V goes and the kernel's small operands.

    A row whose table entry is a sentinel (freed or overrun slot) must drop
    its write, as JAX's out-of-bounds scatter does; PyTorch indexing raises
    instead. Such a row writes to the pool's sink page (the one past the
    allocator's pages, see ``lm.init_paged_cache``), which nothing reads."""

    page: torch.Tensor       # [B] long target page (the sink for dropped rows)
    off: torch.Tensor        # [B] long target offset within the page
    valid_len: torch.Tensor  # [B] int32 = pos + 1
    pages: torch.Tensor      # [B, max_pages] int32 page tables
    hmap: torch.Tensor       # [H] int32 q-head -> kv-head map
    angles: tuple            # RoPE (cos, sin) [B, 1, rot/2] of the positions


def paged_step(cfg: ModelConfig, pages, pos, sink: int,
               page_size: int) -> PagedStep:
    """``sink``: index of the pool's sink page, which is also the table's
    sentinel (the allocator's ``num_pages``)."""
    b, maxp = pages.shape
    dev = pages.device
    pos = torch.as_tensor(pos, device=dev).long().expand(b)
    pidx = pos // page_size
    entry = pages[torch.arange(b, device=dev),
                  pidx.clamp(max=maxp - 1)].long()
    valid = (pidx < maxp) & (entry < sink)
    return PagedStep(
        page=torch.where(valid, entry, sink), off=pos % page_size,
        valid_len=(pos + 1).to(torch.int32),
        pages=pages.to(torch.int32).contiguous(),
        hmap=_hmap_tensor(cfg, dev),
        angles=rotary_angles(pos[:, None], rotary_dims(
            cfg.head_dim, cfg.partial_rotary_factor), cfg.rope_theta))


def _hmap_tensor(cfg: ModelConfig, device) -> torch.Tensor:
    """``_hmap`` computed on the device (no host-to-device copy, which
    would make the host wait for the queued decode work)."""
    rep = max(1, cfg.num_heads // cfg.num_kv_heads)
    h = torch.arange(cfg.padded_heads, device=device) // rep
    return h.clamp(max=cfg.num_kv_heads - 1).to(torch.int32)


def apply_decode_paged(params, cfg: ModelConfig, x, k_pool, v_pool,
                       step: PagedStep):
    """One-token decode against a shared page pool. x: [B, 1, D]; pools
    [num_pages + 1, page_size, KVH, Dh] (one layer's slice, the sink page
    last); ``step``: the step's plan from ``paged_step`` over the
    [B, max_pages] int32 page tables (entries >= num_pages unallocated) and
    the per-row [B] write positions, shared by every layer. The new K/V goes
    to pool page ``pages[b, pos // page_size]``; writes through sentinel
    entries go to the sink page, so a finished slot that keeps riding the
    decode chunk never touches a reassigned page. Attention always goes
    through ``ops.paged_decode_attention`` (the CUDA kernel on the card).
    Returns (out [B, 1, D], k_pool, v_pool)."""
    positions = (step.valid_len.long() - 1)[:, None]
    q, k, v = _project_qkv(params, cfg, x, positions, step.angles)
    k_pool[step.page, step.off] = k[:, 0].to(k_pool.dtype)
    v_pool[step.page, step.off] = v[:, 0].to(v_pool.dtype)
    out = ops.paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                     step.pages, step.valid_len, step.hmap)
    return _out_proj(params, cfg, out, x.dtype), k_pool, v_pool
