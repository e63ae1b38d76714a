"""Plain PyTorch versions of the ported kernels (the allclose targets).

Ports of ``decode_attention``, ``paged_decode_attention``, ``rmsnorm``,
``block_grad_sq_norms`` and ``masked_adamw`` from the JAX package's
``kernels/ref.py``; ``decode_attention_cache``, the dense decode on one
layer's unexpanded cache read through a head map; ``flash_attention_fwd``
and ``flash_attention_bwd``, the math of the JAX package's flash kernels
(``kernels/flash_attention.py``) in one tile, on unexpanded K/V;
``rmsnorm_bwd``, the autograd of ``rmsnorm`` (the JAX package
differentiates its RMSNorm in XLA and has no kernel or oracle for it); and
``banked_masked_adamw``, the gather, ``masked_adamw`` and scatter that the
reference's banked step runs around its kernel. ``ops.py`` takes these for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA and Triton kernels
against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, valid_len, softcap=0.0):
    """q: [B, H, D]; k, v: [B, H, S, D]; valid_len: scalar or per-row [B]
    tensor — masked single-query attention, f32 softmax (f64 for f64
    inputs, the exact evaluation the f32 kernels are held against).
    ``softcap`` > 0 caps the logits (cap tanh(s / cap)), as the model's
    attention does; the kernels take 0 only."""
    s = k.shape[2]
    scale = q.shape[-1] ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    scores = torch.einsum("bhd,bhkd->bhk", q.to(ct), k.to(ct)) * scale
    if softcap and softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    vl = torch.as_tensor(valid_len, device=q.device)
    kpos = torch.arange(s, device=q.device)
    if vl.ndim:
        mask = kpos[None, None, :] < vl[:, None, None]
    else:
        mask = (kpos < vl)[None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs, v.to(ct))
    return out.to(q.dtype)


def decode_attention_cache(q, k_cache, v_cache, valid_len, hmap,
                           softcap=0.0):
    """q: [B, H, D]; k_cache/v_cache: one layer's unexpanded dense cache
    [B, S, KVH, D]; valid_len: scalar or per-row [B]; hmap: [H] int q-head
    -> kv-head map. Expands the cache through hmap and defers to
    ``decode_attention``. The port's one plain dense decode: the model's
    ``attention_core.decode_attention`` calls it too."""
    hm = hmap.long()

    def dense(cache):  # [B, S, KVH, D] -> [B, H, S, D]
        return cache[:, :, hm, :].transpose(1, 2)

    return decode_attention(q, dense(k_cache), dense(v_cache), valid_len,
                            softcap)


def paged_decode_attention(q, k_pool, v_pool, page_tables, valid_len, hmap):
    """q: [B, H, D]; k_pool/v_pool: [num_pages, page_size, KVH, D];
    page_tables: [B, max_pages] int (entries >= num_pages are unallocated
    sentinels: clamped for the gather, masked by valid_len); hmap: [H] int
    q-head -> kv-head map. Gathers the pool into the dense per-row view and
    defers to the dense version."""
    b = q.shape[0]
    num_pages, ps, kvh, d = k_pool.shape
    tbl = page_tables.long().clamp(max=num_pages - 1)
    maxp = tbl.shape[1]
    hm = hmap.long()

    def dense(pool):  # [B, S, KVH, D] -> [B, H, S, D]
        return pool[tbl].reshape(b, maxp * ps, kvh, d)[:, :, hm, :] \
            .transpose(1, 2)

    return decode_attention(q, dense(k_pool), dense(v_pool), valid_len)


def rmsnorm(x, scale, eps=1e-5):
    """x: [..., D]; scale: [D]. f32 statistics, output in the dtype of x."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(dy, x, scale, eps=1e-5, with_dscale=True):
    """(dx, dscale) of ``rmsnorm`` at (x, scale) for the output gradient dy,
    by autograd of the plain forward; dx in the dtype of x, dscale in the
    dtype of scale. ``with_dscale=False``: (dx, None), the scale held
    constant."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sg = scale.detach().requires_grad_(with_dscale)
        wrt = (xg, sg) if with_dscale else (xg,)
        grads = torch.autograd.grad(rmsnorm(xg, sg, eps), wrt, dy)
    return grads[0], (grads[1] if with_dscale else None)


def block_grad_sq_norms(g):
    """g: [L, ...] -> [L] f32 sum of squares over the non-leading axes."""
    gf = g.reshape(g.shape[0], -1).float()
    return (gf * gf).sum(dim=1)


def masked_adamw(p, g, m, v, sel, counts, lr, b1, b2, eps, wd):
    """p, g: [L, R] (param dtype); m, v: [L, R] of one moment dtype (f32 or
    bf16); sel, counts: [L] f32 (counts = post-increment per-block steps).
    Returns (p', m', v'), the masked-AdamW step of the JAX package's
    ``core/masked_adamw.py`` XLA path: m and v widened to f32, the step in
    f32, m' and v' rounded back to the moment dtype last; rows with sel = 0
    come back unchanged."""
    gf = g.float()
    mdt = m.dtype
    m, v = m.float(), v.float()
    selb = (sel > 0)[:, None]
    m2 = torch.where(selb, b1 * m + (1 - b1) * gf, m)
    v2 = torch.where(selb, b2 * v + (1 - b2) * gf * gf, v)
    c = torch.clamp(counts, min=1.0)[:, None]
    mhat = m2 / (1 - b1 ** c)
    vhat = v2 / (1 - b2 ** c)
    pf = p.float()
    step = lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
    p2 = torch.where(selb, pf - step, pf)
    return p2.to(p.dtype), m2.to(mdt), v2.to(mdt)


def banked_masked_adamw(p, g, m, v, slots, sel, counts, lr, b1, b2, eps,
                        wd):
    """p, g: [L, R] (param dtype); m, v: [cap, R] banks (f32 or bf16);
    slots: [cap] int (bank row i holds leaf row ``slots[i]``; ``>= L`` is a
    free slot); sel, counts: [cap] f32. Returns (p', m', v'): ``masked_adamw`` on the
    rows gathered through ``slots`` (free slots read zeros and count as
    unselected), the p rows scattered back where the slot is real."""
    n = p.shape[0]
    valid = slots.long() < n
    rows = torch.where(valid, slots.long(), 0)
    sel = torch.where(valid, sel, 0.0)
    fill = valid[:, None]
    p2, m2, v2 = masked_adamw(torch.where(fill, p[rows], 0),
                              torch.where(fill, g[rows], 0), m, v, sel,
                              counts, lr, b1, b2, eps, wd)
    p_out = p.clone()
    p_out[rows[valid]] = p2[valid]
    return p_out, m2, v2


def _flash_mask(s, device, segment_ids, causal):
    """[B or 1, 1, S, S] bool of the (query, key) pairs that attend."""
    pos = torch.arange(s, device=device)
    ok = (pos[:, None] >= pos[None, :]) if causal else \
        torch.ones(s, s, dtype=torch.bool, device=device)
    ok = ok[None, None]
    if segment_ids is not None:
        ok = ok & (segment_ids[:, None, :, None]
                   == segment_ids[:, None, None, :])
    return ok


def _flash_acc(q):
    """The plain versions' arithmetic: f32, or f64 for f64 inputs."""
    return torch.promote_types(q.dtype, torch.float32)


def flash_attention_fwd(q, k, v, hmap, segment_ids=None, causal=True):
    """q: [B, S, H, D]; k, v: [B, S, KVH, D] (not head-expanded); hmap:
    [H] int q-head -> kv-head map; segment_ids: optional [B, S] int packed
    segment ids (0 = pad; attention stays within equal ids). -> (o
    [B, S, H, D] in the dtype of q, lse [B, H, S] f32). The forward kernel's
    math in one tile: q scaled before q.k, f32 softmax with masked entries
    zeroed, ``lse = m + log(max(l, 1e-30))``. f64 inputs are evaluated in
    f64 (lse too): the accuracy reference of the tests."""
    b, s, h, d = q.shape
    hm = hmap.long()
    acc = _flash_acc(q)
    qf = q.to(acc) * (d ** -0.5)
    kf, vf = k.to(acc)[:, :, hm], v.to(acc)[:, :, hm]
    ok = _flash_mask(s, q.device, segment_ids, causal)
    scores = torch.where(ok, torch.einsum("bqhd,bkhd->bhqk", qf, kf),
                         NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(ok, torch.exp(scores - m[..., None]), 0.0)
    lsum = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / lsum.transpose(1, 2)[..., None]
    return o.to(q.dtype), m + torch.log(lsum)


def flash_attention_bwd(q, k, v, o, lse, do, hmap, segment_ids=None,
                        causal=True):
    """-> (dq [B, S, H, D], dk, dv [B, S, KVH, D]) of ``flash_attention_fwd``
    for the output gradient do, from its saved (o, lse). The backward
    kernels' math in one tile: ``delta = rowsum(do * o)``, p = exp(s - lse)
    with s = (q.k) * scale, ds = p (do.v - delta) scale; dk and dv summed
    over each kv head's q heads. f64 inputs are evaluated in f64."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    hm = hmap.long()
    acc = _flash_acc(q)
    qf, dof = q.to(acc), do.to(acc)
    kf, vf = k.to(acc)[:, :, hm], v.to(acc)[:, :, hm]
    delta = (dof * o.to(acc)).sum(dim=-1).transpose(1, 2)    # [B, H, S]
    ok = _flash_mask(s, q.device, segment_ids, causal)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.where(ok, torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv_h = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    kvh = k.shape[2]
    dk = torch.zeros(b, s, kvh, d, dtype=acc,
                     device=q.device).index_add_(2, hm, dk_h)
    dv = torch.zeros(b, s, kvh, d, dtype=acc,
                     device=q.device).index_add_(2, hm, dv_h)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
