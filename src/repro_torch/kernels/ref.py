"""Plain PyTorch versions of the ported kernels (the allclose targets).

Ports of ``decode_attention``, ``paged_decode_attention``, ``rmsnorm``,
``block_grad_sq_norms`` and ``masked_adamw`` from the JAX package's
``kernels/ref.py``; ``rmsnorm_bwd``, the autograd of ``rmsnorm`` (the
JAX package differentiates its RMSNorm in XLA and has no kernel or oracle
for it); and ``banked_masked_adamw``, the gather, ``masked_adamw`` and
scatter that the reference's banked step runs around its kernel. ``ops.py`` takes these for tensors on the CPU; ``chip_smoke.py``
holds the CUDA and Triton kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, valid_len):
    """q: [B, H, D]; k, v: [B, H, S, D]; valid_len: scalar or per-row [B]
    tensor — masked single-query attention, f32 softmax."""
    s = k.shape[2]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    vl = torch.as_tensor(valid_len, device=q.device)
    kpos = torch.arange(s, device=q.device)
    if vl.ndim:
        mask = kpos[None, None, :] < vl[:, None, None]
    else:
        mask = (kpos < vl)[None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs, v.float())
    return out.to(q.dtype)


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


def rmsnorm_bwd(dy, x, scale, eps=1e-5):
    """(dx, dscale) of ``rmsnorm`` at (x, scale) for the output gradient dy,
    by autograd of the plain forward; dx in the dtype of x, dscale in the
    dtype of scale."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sg = scale.detach().requires_grad_(True)
        dx, ds = torch.autograd.grad(rmsnorm(xg, sg, eps), (xg, sg), dy)
    return dx, ds


def block_grad_sq_norms(g):
    """g: [L, ...] -> [L] f32 sum of squares over the non-leading axes."""
    gf = g.reshape(g.shape[0], -1).float()
    return (gf * gf).sum(dim=1)


def masked_adamw(p, g, m, v, sel, counts, lr, b1, b2, eps, wd):
    """p, g: [L, R] (param dtype); m, v: [L, R] f32; sel, counts: [L] f32
    (counts = post-increment per-block steps). Returns (p', m', v'), the
    masked-AdamW step of the JAX package's ``core/masked_adamw.py``: rows
    with sel = 0 come back unchanged."""
    gf = g.float()
    selb = (sel > 0)[:, None]
    m2 = torch.where(selb, b1 * m + (1 - b1) * gf, m)
    v2 = torch.where(selb, b2 * v + (1 - b2) * gf * gf, v)
    c = torch.clamp(counts, min=1.0)[:, None]
    mhat = m2 / (1 - b1 ** c)
    vhat = v2 / (1 - b2 ** c)
    pf = p.float()
    step = lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
    p2 = torch.where(selb, pf - step, pf)
    return p2.to(p.dtype), m2, v2


def banked_masked_adamw(p, g, m, v, slots, sel, counts, lr, b1, b2, eps,
                        wd):
    """p, g: [L, R] (param dtype); m, v: [cap, R] f32 banks; slots: [cap]
    int (bank row i holds leaf row ``slots[i]``; ``>= L`` is a free slot);
    sel, counts: [cap] f32. Returns (p', m', v'): ``masked_adamw`` on the
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
