"""Attention math of the GQA layers (port of the JAX package's
``attention_core.py``, packed-segment masking included).

GQA uses gather expansion: each q head reads its kv group through a static
index map (``head2group`` / ``attention._hmap``). ``full_attention`` and
``chunked_attention`` are the plain einsum/softmax path: serving prefill
takes it always, and the training forward when ``cfg.use_pallas ==
"never"``; otherwise the training forward calls the flash kernels through
``kernels.ops.flash_attention`` (``attention.apply``). Decode against a
dense cache is ``decode_attention``, which is the plain version of the
dense decode kernel (``kernels.ref.decode_attention_cache``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref

NEG_INF = -1e30


def head2group(num_heads: int, num_kv_heads: int) -> np.ndarray:
    """Static q-head -> kv-group index map (kv-major grouping)."""
    rep = num_heads // num_kv_heads
    return np.arange(num_heads) // rep


def expand_kv(k: torch.Tensor, hmap: np.ndarray) -> torch.Tensor:
    """k: [B, S, KVH, D] -> [B, S, H, D] through the static map ``hmap``
    (identity when KVH == H). Built from runs of equal entries with slices
    and ``expand``, so no index tensor has to be copied to the device."""
    if k.shape[2] == hmap.shape[0] and (hmap == np.arange(len(hmap))).all():
        return k
    runs: list[list[int]] = []
    for g in hmap.tolist():
        if runs and runs[-1][0] == g:
            runs[-1][1] += 1
        else:
            runs.append([g, 1])
    return torch.cat([k[:, :, g:g + 1].expand(-1, -1, n, -1)
                      for g, n in runs], dim=2)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def full_attention(q, k, v, *, hmap=None, causal=True, q_offset=0,
                   softcap=0.0, kv_len_mask=None, q_seg=None, k_seg=None):
    """Exact attention. q: [B, Sq, H, Dh]; k: [B, Sk, KVH, Dh];
    v: [B, Sk, KVH, Dv]; hmap: head2group map (None -> MHA identity);
    kv_len_mask: [B, Sk] bool of valid cache slots. q_seg/k_seg: [B, Sq] /
    [B, Sk] packed segment ids: scores are masked to equal-segment pairs
    (with the causal mask, per-example causal attention; a query keeps its
    own position, so no softmax row is fully masked)."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    if hmap is None:
        hmap = head2group(h, k.shape[2])
    ke = expand_kv(k, hmap).float()
    ve = expand_kv(v, hmap).float()
    qf = q.float() * (dh ** -0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, ke)
    scores = _softcap(scores, softcap)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    if kv_len_mask is not None:
        scores = torch.where(kv_len_mask[:, None, None, :], scores, NEG_INF)
    if q_seg is not None:
        seg_ok = q_seg[:, None, :, None] == k_seg[:, None, None, :]
        scores = torch.where(seg_ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, ve)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, hmap=None, chunk_q=512, causal=True,
                      softcap=0.0, segment_ids=None):
    """Exact causal attention over query chunks of ``chunk_q`` (bounds the
    score working set to [B, H, chunk_q, S]). S must be divisible by
    chunk_q (or <= chunk_q). Under autograd each chunk keeps its own
    probabilities for the backward; the training forward recomputes them
    per layer instead (``lm.scan_stack`` with ``remat="full"``), which is
    what the reference's per-chunk remat buys.

    ``segment_ids``: [B, S] packed segment ids (0 = pad): block-diagonal
    masking as in ``full_attention``; the query-side ids are chunked along
    with q, the key side stays whole."""
    b, s, h, dh = q.shape
    if s <= chunk_q:
        return full_attention(q, k, v, hmap=hmap, causal=causal,
                              softcap=softcap, q_seg=segment_ids,
                              k_seg=segment_ids)
    if s % chunk_q:
        raise ValueError(f"sequence {s} is not a multiple of chunk_q "
                         f"{chunk_q}")
    outs = [full_attention(
        q[:, i:i + chunk_q], k, v, hmap=hmap, causal=causal, q_offset=i,
        softcap=softcap, k_seg=segment_ids,
        q_seg=None if segment_ids is None else segment_ids[:, i:i + chunk_q])
        for i in range(0, s, chunk_q)]
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, *, hmap=None,
                     softcap=0.0):
    """q: [B, 1, H, Dh]; caches [B, Smax, KVH, D*]; cache_len: per-row [B]
    tensor — number of valid cache slots per row (the new token's k/v
    already written); hmap: [H] q-head -> kv-head map (an int tensor on the
    caches' device, or numpy; None -> ``head2group``). The plain dense
    decode of row 3, ``kernels.ref.decode_attention_cache``."""
    b, _, h, dh = q.shape
    if hmap is None:
        hmap = head2group(h, k_cache.shape[2])
    hm = torch.as_tensor(hmap, device=q.device)
    out = ref.decode_attention_cache(q.reshape(b, h, dh), k_cache, v_cache,
                                     cache_len, hm, softcap)
    return out.reshape(b, 1, h, -1)
