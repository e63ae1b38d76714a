"""Kernel wrappers: device dispatch, checks and launch counts.

Each wrapper takes the plain PyTorch version (``ref.py``) only for tensors on
the CPU. For CUDA tensors it checks device, dtype, shape and contiguity,
launches the hand-written kernel, checks the launch, and adds one to its
launch count — or raises. It never falls back to the plain version, a
library call or the CPU. Any other device raises.

``LAUNCHES`` counts kernel launches per wrapper (plain integers); a run sets
them to 0 with ``reset_launches`` and reads them afterwards to show that the
main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_grad_norm as _bgn
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_adamw as _ma
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn

LAUNCHES = {"paged_decode_attention": 0, "decode_attention": 0,
            "rmsnorm": 0, "rmsnorm_bwd": 0, "rmsnorm_bwd_dx": 0,
            "block_grad_sq_norms": 0, "masked_adamw": 0,
            "masked_adamw_bf16m": 0, "banked_masked_adamw": 0,
            "banked_masked_adamw_bf16m": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
_FLOATS = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, first: torch.Tensor, *others: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors (kernel);
    raises for any other device or for tensors on different devices."""
    dev = first.device
    for t in others:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({dev} and {t.device})")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: tensors on {dev} are not supported "
                     f"(cuda launches the kernel, cpu runs the plain version)")


def _fail(name: str, msg: str):
    raise ValueError(f"{name}: {msg}")


def paged_decode_attention(q, k_pool, v_pool, page_tables, valid_len, hmap):
    """q: [B, 1, H, D]; k_pool/v_pool: [num_pages, page_size, KVH, D] shared
    pools (one layer's slice); page_tables: [B, max_pages] int32 (entries >=
    num_pages are unallocated sentinels); valid_len: [B] int32 (>= 1 on the
    serving path); hmap: [H] int32 q-head -> kv-head map -> [B, 1, H, D] in
    the dtype of q. No head-expanded view of the pool is built. One launch
    of the paged decode kernel (row 1), which gives the bits of row 3 on
    the dense view the tables gather; neither the tables nor ``valid_len``
    nor ``hmap`` is read on the host."""
    name = "paged_decode_attention"
    b, one, h, d = q.shape
    if one != 1:
        _fail(name, f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    if not _on_card(name, q, k_pool, v_pool, page_tables, valid_len, hmap):
        out = ref.paged_decode_attention(q.reshape(b, h, d), k_pool, v_pool,
                                         page_tables, valid_len, hmap)
        return out.reshape(b, 1, h, d)
    # messages are formatted only on failure: this runs on every decode step
    num_pages, ps, kvh, dk = k_pool.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        _fail(name, f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        _fail(name, f"pools must share the dtype of q ({q.dtype}), got "
              f"{k_pool.dtype}/{v_pool.dtype}")
    if d not in _dec.HEAD_DIMS or dk != d:
        _fail(name, f"the kernel takes head dim {_dec.HEAD_DIMS}, got q {d} "
              f"and pool {dk}")
    if h > _dec.MAX_HEADS:
        _fail(name, f"the kernel takes at most {_dec.MAX_HEADS} q heads, "
              f"got {h}")
    if v_pool.shape != k_pool.shape:
        _fail(name, f"k/v pool shapes differ: {tuple(k_pool.shape)} vs "
              f"{tuple(v_pool.shape)}")
    if page_tables.ndim != 2 or page_tables.shape[0] != b:
        _fail(name, f"page_tables must be [B={b}, max_pages], got "
              f"{tuple(page_tables.shape)}")
    if valid_len.shape != (b,) or hmap.shape != (h,):
        _fail(name, f"valid_len must be [B={b}] and hmap [H={h}], got "
              f"{tuple(valid_len.shape)} and {tuple(hmap.shape)}")
    for label, t in (("page_tables", page_tables), ("valid_len", valid_len),
                     ("hmap", hmap)):
        if t.dtype != torch.int32:
            _fail(name, f"{label} must be int32, got {t.dtype}")
    for label, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                     ("page_tables", page_tables), ("valid_len", valid_len),
                     ("hmap", hmap)):
        if not t.is_contiguous():
            _fail(name, f"{label} must be contiguous")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        _fail(name, "q and the pools must be 16-byte aligned (the kernel "
              "reads 16-byte vectors)")
    if not (0 < b <= 65535 and kvh > 0 and num_pages > 0 and ps > 0
            and page_tables.shape[1] > 0):
        _fail(name, f"grid out of range (B={b}, KVH={kvh}, pool "
              f"{tuple(k_pool.shape)}, tables {tuple(page_tables.shape)})")
    _dec.load()   # a missing build raises here, before any allocation
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    _dec.launch_paged(q.view(b, h, d), k_pool, v_pool, page_tables,
                      valid_len, hmap, out)
    LAUNCHES[name] += 1
    return out.view(b, 1, h, d)


def decode_attention(q, k_cache, v_cache, valid_len, hmap, *, softcap=0.0):
    """q: [B, 1, H, D]; k_cache/v_cache: one layer's dense cache [B, S, KVH,
    D] (not head-expanded); valid_len: [B] int32 per-row cache length (>= 1
    on the serving path; a CPU call also takes a scalar); hmap: [H] int32
    q-head -> kv-head map -> [B, 1, H, D] in the dtype of q. One launch of
    the dense decode kernel (row 3). ``valid_len`` is not read on the host,
    nor is ``hmap``: on the card a q head whose entry is outside [0, KVH)
    gets zeros (the plain version takes no such map). A logit softcap is
    not implemented by the kernel and raises."""
    name = "decode_attention"
    if softcap:
        _fail(name, f"softcap = {softcap}: the kernel implements no logit "
              f"softcap (0 only)")
    b, one, h, d = q.shape
    if one != 1:
        _fail(name, f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    vl = (valid_len,) if isinstance(valid_len, torch.Tensor) else ()
    if not _on_card(name, q, k_cache, v_cache, hmap, *vl):
        out = ref.decode_attention_cache(q.reshape(b, h, d), k_cache,
                                         v_cache, valid_len, hmap)
        return out.reshape(b, 1, h, d)
    # messages are formatted only on failure: this runs on every decode step
    if not vl:
        _fail(name, "valid_len must be an int32 [B] tensor on the card")
    if q.dtype not in _FLOATS or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        _fail(name, f"q and the caches must share a dtype of float32 or "
              f"bfloat16, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or v_cache.shape != k_cache.shape:
        _fail(name, f"k_cache and v_cache must be [B={b}, S, KVH, D={d}], "
              f"got {tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    if d not in _dec.HEAD_DIMS:
        _fail(name, f"the kernel takes head dim {_dec.HEAD_DIMS}, got {d}")
    if h > _dec.MAX_HEADS:
        _fail(name, f"the kernel takes at most {_dec.MAX_HEADS} q heads, "
              f"got {h}")
    if valid_len.shape != (b,) or hmap.shape != (h,):
        _fail(name, f"valid_len must be [B={b}] and hmap [H={h}], got "
              f"{tuple(valid_len.shape)} and {tuple(hmap.shape)}")
    if valid_len.dtype != torch.int32 or hmap.dtype != torch.int32:
        _fail(name, f"valid_len and hmap must be int32, got "
              f"{valid_len.dtype} and {hmap.dtype}")
    for t in (q, k_cache, v_cache, valid_len, hmap):
        if not t.is_contiguous():
            _fail(name, "every operand must be contiguous")
        if t.data_ptr() % 16:
            _fail(name, "every operand must be 16-byte aligned")
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if not (0 < b <= 65535 and kvh > 0 and s > 0):
        _fail(name, f"grid out of range (B={b}, KVH={kvh}, S={s})")
    _dec.load()   # a missing build raises here, before any allocation
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    _dec.launch(q.view(b, h, d), k_cache, v_cache, valid_len, hmap, out)
    LAUNCHES[name] += 1
    return out.view(b, 1, h, d)


def rmsnorm(x, scale, eps=1e-5):
    """x: [..., D]; scale: [D] -> RMSNorm over the trailing dim, f32
    statistics, output in the dtype of x."""
    name = "rmsnorm"
    if not _on_card(name, x, scale):
        return ref.rmsnorm(x, scale, eps)
    d = x.shape[-1]
    if scale.shape != (d,):
        _fail(name, f"scale must be [D={d}], got {tuple(scale.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        _fail(name, f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype not in (torch.float32, torch.bfloat16):
        _fail(name, f"scale must be float32 or bfloat16, got {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        _fail(name, "x and scale must be contiguous")
    if not 0 < d <= _rn.MAX_D_FWD:
        _fail(name, f"the kernel takes 0 < D <= {_rn.MAX_D_FWD}, got {d}")
    _rn.load_fwd()   # a missing build raises here, before any allocation
    x2d = x.view(-1, d)
    out = torch.empty_like(x2d)
    if x2d.shape[0]:
        _rn.launch(x2d, scale, float(eps), out)
        LAUNCHES[name] += 1
    return out.view(x.shape)


def rmsnorm_bwd(dy, x, scale, eps=1e-5, with_dscale=True):
    """The backward of ``rmsnorm``: dy, x: [..., D]; scale: [D] -> (dx in
    the dtype of x, dscale in the dtype of scale). One launch is the row
    pass and its dscale column sum, counted as ``rmsnorm_bwd``.
    ``with_dscale=False`` (a frozen layer's norm): (dx, None) from the row
    pass alone, with no column sums, no partials and no second kernel,
    counted as ``rmsnorm_bwd_dx``; its dx has the bits of the full mode's."""
    name = "rmsnorm_bwd" if with_dscale else "rmsnorm_bwd_dx"
    if not _on_card(name, dy, x, scale):
        return ref.rmsnorm_bwd(dy, x, scale, eps, with_dscale=with_dscale)
    d = x.shape[-1]
    if dy.shape != x.shape or scale.shape != (d,):
        _fail(name, f"dy {tuple(dy.shape)} must match x {tuple(x.shape)} "
              f"and scale must be [D={d}], got {tuple(scale.shape)}")
    if x.dtype not in _FLOATS or dy.dtype != x.dtype \
            or scale.dtype not in _FLOATS:
        _fail(name, f"x and dy must share a dtype of float32 or bfloat16 "
              f"and scale be one of them, got {x.dtype}/{dy.dtype}/"
              f"{scale.dtype}")
    if not (dy.is_contiguous() and x.is_contiguous()
            and scale.is_contiguous()):
        _fail(name, "dy, x and scale must be contiguous")
    if not 0 < d <= _rn.MAX_D_BWD:
        _fail(name, f"the kernel takes 0 < D <= {_rn.MAX_D_BWD}, got {d}")
    _rn.load()
    x2d = x.view(-1, d)
    dx = torch.empty_like(x2d)
    dscale = torch.empty_like(scale) if with_dscale else None
    _rn.launch_bwd(x2d, scale, dy.view(-1, d), float(eps), dx, dscale)
    LAUNCHES[name] += 1
    return dx.view(x.shape), dscale


def block_grad_sq_norms(g):
    """g: [L, ...] stacked gradient leaf (f32 or bf16) -> [L] f32 sum of
    squares over the non-leading axes. Deterministic: the same input gives
    the same bits. One launch is both stages of the reduction."""
    name = "block_grad_sq_norms"
    if not _on_card(name, g):
        return ref.block_grad_sq_norms(g)
    if g.ndim < 2 or g.numel() == 0:
        _fail(name, f"g must be a nonempty [L, ...] leaf, got "
              f"{tuple(g.shape)}")
    if g.dtype not in _FLOATS:
        _fail(name, f"g must be float32 or bfloat16, got {g.dtype}")
    if not g.is_contiguous():
        _fail(name, "g must be contiguous")
    _bgn.load()
    out = torch.empty((g.shape[0],), dtype=torch.float32, device=g.device)
    _bgn.launch(g.view(g.shape[0], -1), out)
    LAUNCHES[name] += 1
    return out


def _check_adamw_dtypes(name, p, g, m, v, sel, counts) -> None:
    """Rows 8 and 9: p and g of one float dtype, m and v of one (f32 or
    bf16, independent of p's), sel and counts f32."""
    if p.dtype not in _FLOATS or g.dtype != p.dtype:
        _fail(name, f"p and g must share a dtype of float32 or bfloat16, "
              f"got {p.dtype}/{g.dtype}")
    if m.dtype not in _FLOATS or v.dtype != m.dtype:
        _fail(name, f"m and v must share a moment dtype of float32 or "
              f"bfloat16, got {m.dtype}/{v.dtype}")
    for label, t in (("sel", sel), ("counts", counts)):
        if t.dtype != torch.float32:
            _fail(name, f"{label} must be float32, got {t.dtype}")


def _moment_name(name: str, m: torch.Tensor) -> str:
    """The launch count of rows 8 and 9: bf16 moments count apart."""
    return name + "_bf16m" if m.dtype == torch.bfloat16 else name


def masked_adamw(p, g, m, v, sel, counts, lr, b1, b2, eps, wd):
    """Masked AdamW over a stacked leaf, IN PLACE on p, m and v. p, g:
    [L, ...] in the param dtype; m, v: [L, ...] of one moment dtype, f32 or
    bf16 (computed in f32, rounded to nearest even when stored); sel,
    counts: [L] f32 (counts = post-increment per-block steps); lr and the
    hyper-parameters are Python floats. Rows with sel = 0 keep p, m and v
    bit for bit. A launch on bf16 moments counts as ``masked_adamw_bf16m``.
    Returns (p, m, v)."""
    name = "masked_adamw"
    if not _on_card(name, p, g, m, v, sel, counts):
        nl = p.shape[0]
        p2, m2, v2 = ref.masked_adamw(p.view(nl, -1), g.view(nl, -1),
                                      m.view(nl, -1), v.view(nl, -1), sel,
                                      counts, lr, b1, b2, eps, wd)
        p.view(nl, -1).copy_(p2)
        m.view(nl, -1).copy_(m2)
        v.view(nl, -1).copy_(v2)
        return p, m, v
    nl = p.shape[0]
    if p.ndim < 2 or g.shape != p.shape or m.shape != p.shape \
            or v.shape != p.shape:
        _fail(name, f"p, g, m, v must be [L, ...] of one shape, got "
              f"{tuple(p.shape)}, {tuple(g.shape)}, {tuple(m.shape)}, "
              f"{tuple(v.shape)}")
    if sel.shape != (nl,) or counts.shape != (nl,):
        _fail(name, f"sel and counts must be [L={nl}], got "
              f"{tuple(sel.shape)} and {tuple(counts.shape)}")
    _check_adamw_dtypes(name, p, g, m, v, sel, counts)
    for label, t in (("p", p), ("g", g), ("m", m), ("v", v), ("sel", sel),
                     ("counts", counts)):
        if not t.is_contiguous():
            _fail(name, f"{label} must be contiguous")
    _ma.load()
    _ma.launch(p.view(nl, -1), g.view(nl, -1), m.view(nl, -1),
               v.view(nl, -1), sel, counts, lr, b1, b2, eps, wd)
    LAUNCHES[_moment_name(name, m)] += 1
    return p, m, v


def banked_masked_adamw(p, g, m, v, slots, sel, counts, lr, b1, b2, eps,
                        wd):
    """Masked AdamW over the bank rows of a stacked leaf, IN PLACE. p, g:
    [L, ...] in the param dtype; m, v: [cap, ...] banks of one moment
    dtype (f32 or bf16, as in ``masked_adamw``) whose row i holds the
    moments of leaf row ``slots[i]`` (int32 [cap]; ``>= L`` is a free
    slot); sel, counts: [cap] f32. The p rows ``slots[i]`` with sel > 0 and
    the bank rows take the step; free slots, rows with sel = 0 and the leaf
    rows no slot holds keep their bits. A launch on bf16 moments counts as
    ``banked_masked_adamw_bf16m``. Returns (p, m, v)."""
    name = "banked_masked_adamw"
    if not _on_card(name, p, g, m, v, slots, sel, counts):
        nl, cap = p.shape[0], m.shape[0]
        p2, m2, v2 = ref.banked_masked_adamw(
            p.view(nl, -1), g.view(nl, -1), m.view(cap, -1),
            v.view(cap, -1), slots, sel, counts, lr, b1, b2, eps, wd)
        p.view(nl, -1).copy_(p2)
        m.view(cap, -1).copy_(m2)
        v.view(cap, -1).copy_(v2)
        return p, m, v
    nl, cap = p.shape[0], m.shape[0]
    if p.ndim < 2 or g.shape != p.shape or v.shape != m.shape \
            or m.shape[1:] != p.shape[1:]:
        _fail(name, f"p, g must be [L, ...] and m, v [cap, ...] with the "
              f"same trailing shape, got {tuple(p.shape)}, {tuple(g.shape)},"
              f" {tuple(m.shape)}, {tuple(v.shape)}")
    if slots.shape != (cap,) or sel.shape != (cap,) \
            or counts.shape != (cap,):
        _fail(name, f"slots, sel and counts must be [cap={cap}], got "
              f"{tuple(slots.shape)}, {tuple(sel.shape)} and "
              f"{tuple(counts.shape)}")
    if slots.dtype != torch.int32:
        _fail(name, f"slots must be int32, got {slots.dtype}")
    _check_adamw_dtypes(name, p, g, m, v, sel, counts)
    for label, t in (("p", p), ("g", g), ("m", m), ("v", v),
                     ("slots", slots), ("sel", sel), ("counts", counts)):
        if not t.is_contiguous():
            _fail(name, f"{label} must be contiguous")
    _ma.load()
    _ma.launch_banked(p.view(nl, -1), g.view(nl, -1), m.view(cap, -1),
                      v.view(cap, -1), slots, sel, counts, lr, b1, b2, eps,
                      wd)
    LAUNCHES[_moment_name(name, m)] += 1
    return p, m, v


def _check_flash(name, q, k, v, hmap, segment_ids, *more):
    """What the flash kernels take: q [B, S, H, D], k/v [B, S, KVH, D] of
    one float dtype, head dim 64 or 128, int32 hmap [H] and segment ids
    [B, S], contiguous and 16-byte aligned, the grid in range."""
    b, s, h, d = q.shape
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        _fail(name, f"q, k, v must share a dtype of float32 or bfloat16, "
              f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.ndim != 4 or k.shape[:2] != (b, s) or k.shape[3] != d \
            or v.shape != k.shape:
        _fail(name, f"k and v must be [B={b}, S={s}, KVH, D={d}], got "
              f"{tuple(k.shape)} and {tuple(v.shape)}")
    if d not in _fa.HEAD_DIMS:
        _fail(name, f"the kernels take head dim {_fa.HEAD_DIMS}, got {d}")
    if hmap.shape != (h,) or hmap.dtype != torch.int32:
        _fail(name, f"hmap must be int32 [H={h}], got {hmap.dtype} "
              f"{tuple(hmap.shape)}")
    if segment_ids is not None and (segment_ids.shape != (b, s)
                                    or segment_ids.dtype != torch.int32):
        _fail(name, f"segment_ids must be int32 [B={b}, S={s}], got "
              f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
    for t in (q, k, v, hmap, segment_ids, *more):
        if t is not None and not t.is_contiguous():
            _fail(name, "every operand must be contiguous")
        if t is not None and t.data_ptr() % 16:
            _fail(name, "every operand must be 16-byte aligned")
    if not (s > 0 and 0 < b * h <= 65535 and b * k.shape[2] <= 65535):
        _fail(name, f"grid out of range (B={b}, S={s}, H={h})")


def flash_attention_fwd(q, k, v, hmap, *, causal=True, segment_ids=None):
    """q: [B, S, H, D]; k, v: [B, S, KVH, D] (not head-expanded); hmap: [H]
    int32 q-head -> kv-head map; segment_ids: optional [B, S] int32 (0 =
    pad) -> (o [B, S, H, D] in the dtype of q, lse [B, H, S] f32). One
    launch of the forward kernel (row 4)."""
    name = "flash_attention_fwd"
    ids = () if segment_ids is None else (segment_ids,)
    if not _on_card(name, q, k, v, hmap, *ids):
        return ref.flash_attention_fwd(q, k, v, hmap, segment_ids, causal)
    _check_flash(name, q, k, v, hmap, segment_ids)
    _fa.load()
    b, s, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _fa.launch_fwd(q, k, v, segment_ids, hmap, causal, o, lse)
    LAUNCHES[name] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, hmap, *, causal=True,
                        segment_ids=None):
    """-> (dq, dk, dv) of ``flash_attention_fwd`` for the output gradient
    do, from its saved (o, lse); dk and dv summed over each kv head's q
    heads in a fixed order (the same inputs give the same bits). ``delta =
    rowsum(do * o)`` is a torch reduction; then one launch each of the dq
    (row 5) and the dk/dv (row 6) kernels."""
    name = "flash_attention_bwd"
    ids = () if segment_ids is None else (segment_ids,)
    if not _on_card(name, q, k, v, o, lse, do, hmap, *ids):
        return ref.flash_attention_bwd(q, k, v, o, lse, do, hmap,
                                       segment_ids, causal)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        _fail(name, f"o and do must be like q {tuple(q.shape)} {q.dtype}, "
              f"got {tuple(o.shape)} {o.dtype} and {tuple(do.shape)} "
              f"{do.dtype}")
    b, s, h, _ = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        _fail(name, f"lse must be float32 [B, H, S] = {(b, h, s)}, got "
              f"{lse.dtype} {tuple(lse.shape)}")
    _check_flash(name, q, k, v, hmap, segment_ids, o, lse, do)
    _fa.load()
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _fa.launch_bwd_dq(q, k, v, do, lse, delta, segment_ids, hmap, causal, dq)
    LAUNCHES["flash_attention_bwd_dq"] += 1
    _fa.launch_bwd_dkv(q, k, v, do, lse, delta, segment_ids, hmap, causal,
                       dk, dv)
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel; its backward the dq and dk/dv kernels. Saves q,
    k, v, o and lse: no head-expanded K/V and no [S, S] scores."""

    @staticmethod
    def forward(ctx, q, k, v, hmap, segment_ids, causal):
        o, lse = flash_attention_fwd(q, k, v, hmap, causal=causal,
                                     segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, hmap, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, hmap, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), hmap, causal=ctx.causal,
            segment_ids=segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, hmap, *, causal=True, segment_ids=None,
                    softcap=0.0):
    """Differentiable flash attention in the layer's layout: q [B, S, H,
    D]; k, v [B, S, KVH, D] read through the int32 [H] map ``hmap``;
    ``segment_ids``: optional [B, S] int32 packed segment ids (0 = pad),
    attention block-diagonal over equal ids -> o [B, S, H, D]. The kernels
    (rows 4-6) on CUDA tensors, their plain versions on CPU tensors. A
    logit softcap is not implemented by the kernels and raises."""
    if softcap:
        _fail("flash_attention", f"softcap = {softcap}: the kernels "
              f"implement no logit softcap (0 only)")
    return _FlashAttention.apply(q, k, v, hmap, segment_ids, causal)
