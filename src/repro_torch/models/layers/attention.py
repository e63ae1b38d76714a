"""GQA/MHA attention layer with RoPE, optional QKV bias and KV caching
(port of the JAX package's ``attention.py``: the training forward, prefill,
dense-cache decode, paged-pool decode and the chunk of an incremental
prefill). The training forward runs the flash kernels
(``ops.flash_attention``) and the dense decode the dense decode kernel
(``ops.decode_attention``) unless ``cfg.use_pallas == "never"``; the paged
decode always runs the paged kernel, prefill the plain
``chunked_attention`` and a prefill chunk the plain ``full_attention``
(XLA in the reference, no Pallas kernel).

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
                                            rotary_dims, rotor)


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


def _project(x2, w, bs, bias=None):
    """einsum("bsd,dhk->bshk") (+ bias [h, k]) as one matrix product:
    ``x2`` is x [B, S, D] as [B * S, D], ``bs`` = (B, S)."""
    w2 = w.reshape(w.shape[0], -1)
    y = x2 @ w2 if bias is None else torch.addmm(bias.reshape(-1), x2, w2)
    return y.view(*bs, *w.shape[1:])


def _project_qkv(params, cfg: ModelConfig, x, positions, rot_c=None):
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    bias = cfg.attn_bias
    q = _project(x2, params["wq"], (b, s), params["bq"] if bias else None)
    k = _project(x2, params["wk"], (b, s), params["bk"] if bias else None)
    v = _project(x2, params["wv"], (b, s), params["bv"] if bias else None)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor,
                   rot_c)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor,
                   rot_c)
    return q, k, v


def _out_proj(params, out, dtype, hm):
    """``hm``: ``_head_mask`` in ``dtype`` (None when no head is padded)."""
    out = out.to(dtype)
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
    return _out_proj(params, out, x.dtype,
                     _head_mask(cfg, x.dtype, x.device))


def apply_prefill(params, cfg: ModelConfig, x, *, cache_len: int = 0):
    """Causal prefill. x: [B, S, D] -> (out [B, S, D], (k, v)) with k/v
    [B, max(S, cache_len), KVH, Dh], zero past S."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = core.chunked_attention(q, k, v, hmap=_hmap(cfg), causal=True,
                                 softcap=cfg.attn_logit_softcap)
    out = _out_proj(params, out, x.dtype, _head_mask(cfg, x.dtype, x.device))
    if cache_len and cache_len > s:
        pad = (0, 0, 0, 0, 0, cache_len - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return out, (k, v)


def apply_prefill_chunk(params, cfg: ModelConfig, x, k_cache, v_cache,
                        start: int):
    """One chunk of an incremental prefill. x: [B, C, D] chunk tokens at
    positions [start, start+C); caches [B, Smax, KVH, Dh] carry every
    earlier chunk's K/V. Writes this chunk's K/V at ``start`` (in place)
    and attends the chunk queries over the whole cache with the causal
    mask anchored at ``q_offset=start``; cache positions past start+C are
    zero AND causally masked, so the result equals the single-shot prefill
    chunk for chunk. Returns (out [B, C, D], k_cache, v_cache)."""
    b, c, _ = x.shape
    if start < 0 or start + c > k_cache.shape[1]:
        raise ValueError(f"chunk [{start}, {start + c}) does not fit a cache "
                         f"of {k_cache.shape[1]} positions")
    positions = start + torch.arange(c, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    k_cache[:, start:start + c] = k.to(k_cache.dtype)
    v_cache[:, start:start + c] = v.to(v_cache.dtype)
    out = core.full_attention(q, k_cache, v_cache, hmap=_hmap(cfg),
                              causal=True, q_offset=start,
                              softcap=cfg.attn_logit_softcap)
    out = _out_proj(params, out, x.dtype, _head_mask(cfg, x.dtype, x.device))
    return out, k_cache, v_cache


@dataclass
class DenseStep:
    """Per-decode-step plan shared by every layer's dense-cache write and
    attention call (the counterpart of ``PagedStep``): the write positions
    and the kernel's small operands, built once per step on the device."""

    flat: torch.Tensor       # [B] long row-major index of (row, write
    #                          position clamped into the cache) in [B * Smax]
    inside: torch.Tensor     # [B, 1, 1] bool: the write lands in the cache
    valid_len: torch.Tensor  # [B] int32 = pos + 1
    hmap: torch.Tensor       # [H] int32 q-head -> kv-head map
    rot_c: torch.Tensor      # RoPE ``rotor`` [B, 1, 1, rot/2] of the positions
    head_mask: torch.Tensor | None  # ``_head_mask`` in the activations' dtype


def _rotor_at(cfg: ModelConfig, pos) -> torch.Tensor:
    return rotor(rotary_angles(pos[:, None], rotary_dims(
        cfg.head_dim, cfg.partial_rotary_factor), cfg.rope_theta))


def dense_step(cfg: ModelConfig, pos, max_len: int, dtype) -> DenseStep:
    """``pos``: per-row [B] write positions on the device; ``max_len``: the
    cache length; ``dtype``: the activations'."""
    dev = pos.device
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=dev)
    return DenseStep(
        flat=rows * max_len + pos.clamp(max=max_len - 1),
        inside=(pos < max_len)[:, None, None],
        valid_len=(pos + 1).to(torch.int32), hmap=_hmap_tensor(cfg, dev),
        rot_c=_rotor_at(cfg, pos), head_mask=_head_mask(cfg, dtype, dev))


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
    q, k, v = _project_qkv(params, cfg, x, None, step.rot_c)
    # each row writes only its own cache row, so the clamped write-back of
    # the old value for a dropped row cannot collide with another row;
    # index_select / index_copy_ on the [B * Smax] view cost the host less
    # than indexing by (rows, positions)
    for cache, new in ((k_cache, k), (v_cache, v)):
        rows = cache.view(-1, *cache.shape[2:])
        rows.index_copy_(0, step.flat, torch.where(
            step.inside, new[:, 0].to(cache.dtype),
            rows.index_select(0, step.flat)))
    if cfg.use_pallas == "never":
        out = core.decode_attention(q, k_cache, v_cache, step.valid_len,
                                    hmap=step.hmap,
                                    softcap=cfg.attn_logit_softcap)
    else:
        out = ops.decode_attention(q.contiguous(), k_cache, v_cache,
                                   step.valid_len, step.hmap,
                                   softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out, x.dtype, step.head_mask), k_cache, v_cache


@dataclass
class PagedStep:
    """Per-decode-step plan shared by every layer's paged write and kernel
    call: where each row's new K/V goes and the kernel's small operands.

    A row whose table entry is a sentinel (freed or overrun slot) must drop
    its write, as JAX's out-of-bounds scatter does; PyTorch indexing raises
    instead. Such a row writes to the pool's sink page (the one past the
    allocator's pages, see ``lm.init_paged_cache``), which nothing reads."""

    flat: torch.Tensor       # [B] long target page (the sink for dropped
    #                          rows) x page_size + offset within the page
    valid_len: torch.Tensor  # [B] int32 = pos + 1
    pages: torch.Tensor      # [B, max_pages] int32 page tables
    hmap: torch.Tensor       # [H] int32 q-head -> kv-head map
    rot_c: torch.Tensor      # RoPE ``rotor`` [B, 1, 1, rot/2] of the positions
    head_mask: torch.Tensor | None  # ``_head_mask`` in the activations' dtype


def paged_step(cfg: ModelConfig, pages, pos, sink: int, page_size: int,
               dtype) -> PagedStep:
    """``sink``: index of the pool's sink page, which is also the table's
    sentinel (the allocator's ``num_pages``); ``dtype``: the
    activations'."""
    b, maxp = pages.shape
    dev = pages.device
    pos = torch.as_tensor(pos, device=dev).long().expand(b)
    pidx = pos // page_size
    entry = pages[torch.arange(b, device=dev),
                  pidx.clamp(max=maxp - 1)].long()
    valid = (pidx < maxp) & (entry < sink)
    return PagedStep(
        flat=torch.where(valid, entry, sink) * page_size + pos % page_size,
        valid_len=(pos + 1).to(torch.int32),
        pages=pages.to(torch.int32).contiguous(),
        hmap=_hmap_tensor(cfg, dev), rot_c=_rotor_at(cfg, pos),
        head_mask=_head_mask(cfg, dtype, dev))


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
    to pool page ``pages[b, pos // page_size]`` (written through the
    pool's [pages * page_size] view); writes through sentinel
    entries go to the sink page, so a finished slot that keeps riding the
    decode chunk never touches a reassigned page. Attention always goes
    through ``ops.paged_decode_attention`` (the CUDA kernel on the card).
    Returns (out [B, 1, D], k_pool, v_pool)."""
    q, k, v = _project_qkv(params, cfg, x, None, step.rot_c)
    for pool, new in ((k_pool, k), (v_pool, v)):
        pool.view(-1, *pool.shape[2:]).index_copy_(
            0, step.flat, new[:, 0].to(pool.dtype))
    out = ops.paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                     step.pages, step.valid_len, step.hmap)
    return _out_proj(params, out, x.dtype, step.head_mask), k_pool, v_pool
