"""Decoder-only language model, dense family (port of the dense half of the
JAX package's ``models/lm.py``: init, the training forward, prefill,
caches, slot insertion and decode).

Parameters keep the reference tree: the same key names, and the transformer
blocks STACKED under ``"layers"`` with a leading [L] axis, so parameters
convert one to one (``convert.py``) and kernels see the same rows. The
reference's ``lax.scan`` over layers is a Python loop over that axis.

``batch``: {"tokens": [B, S] int tensor}, and for packed SFT batches also
``segment_ids`` and ``positions`` [B, S] int32. Caches are dicts of
tensors and are updated in place by ``decode_step``, ``prefill_chunk`` and
the ``insert_slots*`` functions.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gated
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import attention, norms

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def check_supported(cfg: ModelConfig) -> None:
    """This slice ports the dense GQA/MHA family; other families and
    options raise instead of running another path."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (ROADMAP Queue A, "
            f"'Other families'); the port serves the dense family")
    for flag, item in (("use_mla", "Other families"),
                       ("mtp_depth", "Other families"),
                       ("seq_shard_kv", "Distributed")):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{flag}={getattr(cfg, flag)!r} is not ported yet (ROADMAP "
                f"Queue A, {item!r})")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# --------------------------------------------------------------- params


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as {key: (shape, init std or 'zeros'/'ones')},
    the shapes of the reference ``lm.init``."""
    d, dff = cfg.d_model, cfg.d_ff
    hp, kvh, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    n, sc = cfg.num_layers, d ** -0.5
    attn = {"wq": ((n, d, hp, dh), sc), "wk": ((n, d, kvh, dh), sc),
            "wv": ((n, d, kvh, dh), sc), "wo": ((n, hp, dh, d), sc)}
    if cfg.attn_bias:
        attn.update(bq=((n, hp, dh), "zeros"), bk=((n, kvh, dh), "zeros"),
                    bv=((n, kvh, dh), "zeros"))
    specs = {
        "embed": {"tok": ((cfg.padded_vocab_size, d), sc)},
        "final_norm": {"scale": ((d,), "ones")},
        "layers": {
            "ln1": {"scale": ((n, d), "ones")},
            "attn": attn,
            "ln2": {"scale": ((n, d), "ones")},
            "mlp": {"wg": ((n, d, dff), sc), "wu": ((n, d, dff), sc),
                    "wd": ((n, dff, d), dff ** -0.5)},
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((d, cfg.padded_vocab_size), sc)}
    return specs


def _is_spec(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple)


def param_shapes(cfg: ModelConfig) -> dict:
    def walk(t):
        return {k: (v[0] if _is_spec(v) else walk(v)) for k, v in t.items()}
    return walk(param_specs(cfg))


# f32 elements one draw of ``init`` holds, unless one slice along a leaf's
# leading axis is larger (then one slice a draw)
INIT_DRAW = 1 << 26


def init(cfg: ModelConfig, generator: torch.Generator | None = None, *,
         device="cuda") -> dict:
    """Random parameters with the reference's shapes and scales (normal
    weights, zero biases, unit norm scales), drawn from ``generator`` (a
    generator on ``device``; default: seed 0) in a fixed key order.

    Each weight leaf is drawn in slices along its leading axis, as many
    slices a draw as fit in ``INIT_DRAW`` f32 elements (at least one), each
    scaled in place and cast into the leaf: the f32 temporary is at most
    one draw (one [d_model, d_ff] layer of qwen2.5-32b's ``mlp.wg``, 0.57
    GB), never the whole leaf in f32 (36 GB for that one)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dt = dtype_of(cfg)

    def make(shape, how):
        if how == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if how == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        out = torch.empty(shape, dtype=dt, device=dev)
        row = math.prod(shape[1:])
        step = max(1, INIT_DRAW // max(1, row))
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            w = torch.randn((n,) + tuple(shape[1:]), generator=generator,
                            device=dev)
            out[i:i + n].copy_(w.mul_(how))
        return out

    def walk(t):
        return {k: (make(*v) if _is_spec(v) else walk(v))
                for k, v in t.items()}
    return walk(param_specs(cfg))


def layers_of(stacked: dict, n: int) -> list[dict]:
    """The ``n`` blocks' parameters, each leaf split along its leading [L]
    axis by one ``unbind`` (a leaf's layers are views of it): one call a
    leaf, not one a leaf and block, for a decode step bound by the host."""
    split = _split(stacked)
    return [_layer(split, i) for i in range(n)]


def _split(tree: dict) -> dict:
    return {k: (_split(v) if isinstance(v, dict) else v.unbind(0))
            for k, v in tree.items()}


def _embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"]["tok"][tokens.long()]


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        out = x @ params["embed"]["tok"].T
    else:
        out = x @ params["lm_head"]["w"]
    if cfg.logits_softcap:
        out = torch.tanh(out / cfg.logits_softcap) * cfg.logits_softcap
    vp = cfg.padded_vocab_size
    if vp != cfg.vocab_size:
        # vocab padding: pad logits masked to -1e30 (never decoded)
        real = torch.arange(vp, device=out.device) < cfg.vocab_size
        out = out + torch.where(real, 0.0, -1e30).to(out.dtype)
    return out


# --------------------------------------------------------------- train fwd


def _remat(fn, cfg: ModelConfig):
    """``remat="full"``: recompute the layer in the backward instead of
    keeping its activations (``jax.checkpoint`` of the reference)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        def remat_fn(*args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return remat_fn
    raise NotImplementedError(
        f"remat={cfg.remat!r} is not ported (it names a jax.checkpoint "
        f"policy); use 'full' or 'none'")


class _Unbind(torch.autograd.Function):
    """``torch.unbind(x, 0)`` whose backward stacks the layers' gradients
    in one launch, as torch's does, but fills the rows that got none (the
    frozen layers under the gate) from a single zero: torch's makes a zero
    tensor, and launches a fill, for each such row."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        return x.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        if all(g is not None for g in grads):
            return torch.stack(grads)
        some = next((g for g in grads if g is not None), None)
        if some is None:
            return None
        zero = some.new_zeros(()).expand(some.shape)
        return torch.stack([zero if g is None else g for g in grads])


def _unbind(tree: dict) -> dict:
    """Each stacked leaf as a tuple of its layers (one ``unbind`` a leaf)."""
    return {k: (_unbind(v) if isinstance(v, dict) else _Unbind.apply(v))
            for k, v in tree.items()}


def _layer(unbound: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in unbound.items()}


def scan_stack(cfg: ModelConfig, apply_fn, x, stacked: dict, masks=None):
    """``apply_fn(params_l, x) -> x`` over the layers of a stacked group,
    in order (the reference's ``lax.scan``). Each leaf is split into its
    layers by one ``unbind`` outside the checkpointed function: its backward
    stacks the layers' gradients once, where indexing ``w[i]`` per layer
    would write a full [L, ...] zero tensor for every layer.

    If ``cfg.gate_weight_grads`` and ``masks`` (a host sequence of L
    bools, or a CPU tensor) is given, a frozen layer's parameters are
    detached before the remat wrapper sees them (``core/gated.py``): the
    backward computes no weight gradient of theirs, and their rows of the
    stacked gradient are zero."""
    gate = cfg.gate_weight_grads and masks is not None
    if gate and len(masks) != cfg.num_layers:
        raise ValueError(f"masks has {len(masks)} entries for "
                         f"{cfg.num_layers} layers")
    unbound = _unbind(stacked)
    body = _remat(apply_fn, cfg)
    for i in range(cfg.num_layers):
        p_l = _layer(unbound, i)
        if gate:
            p_l = gated.gate_layer(p_l, bool(masks[i]))
        x = body(p_l, x)
    return x


def _check_packed_support(cfg: ModelConfig):
    """Packed batches need block-diagonal attention; families whose token
    mixing is not per-position-maskable and the MLA/vlm/MTP paths do not
    implement it, so they are refused rather than trained across example
    boundaries (the reference's check)."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"segment-packed batches are not supported for family="
            f"{cfg.family!r}: the SSM state scan carries context across "
            f"segment boundaries. Use the unpacked pipeline (pack=False) "
            f"for this architecture.")
    if cfg.family == "vlm":
        raise ValueError(
            "segment-packed batches are not supported for family='vlm' "
            "(the patch prefix is shared by every row); use pack=False")
    if cfg.use_mla:
        raise ValueError(
            "segment-packed batches are not implemented for MLA attention; "
            "use pack=False or a GQA/MHA architecture")
    if cfg.mtp_depth:
        raise ValueError(
            "segment-packed batches are not implemented for mtp_depth > 0: "
            "the MTP head's attention is not segment-masked and its "
            "shift-2 loss would cross example boundaries; use pack=False")


def apply_train(params: dict, cfg: ModelConfig, batch: dict, masks=None):
    """-> (logits [B, S, V] aligned to batch["tokens"], aux_loss, extra).
    Dense family; ``aux_loss`` is a 0-d f32 zero and ``extra`` empty, as
    the reference gives for it. Packed SFT batches also carry
    ``segment_ids`` [B, S] (0 = pad) and ``positions`` [B, S] (reset at
    each segment): attention is block-diagonal over segments and RoPE sees
    each example at its unpacked positions, so the packed forward equals
    running every segment as its own row. ``masks``: the body groups' layer
    masks on the host (``partition.layer_masks_dict``), which gate the
    weight gradients under ``cfg.gate_weight_grads`` (see ``scan_stack``)."""
    segment_ids = batch.get("segment_ids")
    if segment_ids is not None:
        _check_packed_support(cfg)
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    x = _embed_tokens(params, cfg, tokens)

    def block(p_l, h):
        return blocks.attn_block_apply(p_l, cfg, h, positions=positions,
                                       segment_ids=segment_ids)

    x = scan_stack(cfg, block, x, params["layers"],
                   masks=None if masks is None else masks["layers"])
    x = norms.apply(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)
    return logits, torch.zeros((), device=x.device), {}


# --------------------------------------------------------------- caches


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda") -> dict:
    """Slot-based dense cache: k/v [L, B, max_len, KVH, Dh] and a per-slot
    ``pos`` [B] int32 (tokens written per slot)."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def init_paged_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                     page_size: int, num_pages: int, device="cuda") -> dict:
    """Paged serve cache: K/V live in shared pools [L, num_pages + 1,
    page_size, KVH, Dh] and each slot maps positions through ``pages``
    [B, max_pages] (int32; the ``num_pages`` sentinel marks unallocated
    entries). Page ``num_pages`` is a sink: writes through sentinel entries
    land there, where JAX's out-of-bounds scatter drops them, and nothing
    reads it (the kernel reads only positions below ``valid_len``, whose
    pages are allocated)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    maxp = -(-max_len // page_size)
    shape = (cfg.num_layers, num_pages + 1, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            "pages": torch.full((batch_size, maxp), num_pages,
                                dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


# --------------------------------------------------------------- prefill


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int, *,
            lengths=None):
    """-> (logits [B, V] at each row's last prompt token, dense cache with
    k/v [L, B, max_len, KVH, Dh]). ``lengths`` ([B]): true prompt lengths
    when ``tokens`` is right-padded to a shared bucket; each row's logits are
    gathered at ``lengths - 1`` and ``cache["pos"] = lengths`` (attention is
    causal, so pad tokens to the right change nothing)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    ks, vs = [], []
    for p_l in layers_of(params["layers"], cfg.num_layers):
        x, (k, v) = blocks.attn_block_prefill(p_l, cfg, x, cache_len=max_len)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = norms.apply(params["final_norm"], x, cfg.norm_eps)
    if lengths is None:
        logits = _logits(params, cfg, x[:, -1:, :])[:, 0]
        cache["pos"] = torch.full((b,), s, dtype=torch.int32,
                                  device=x.device)
    else:
        lv = torch.as_tensor(lengths, device=x.device).to(torch.int32)
        lv = lv.expand(b)
        rows = torch.arange(b, device=x.device)
        xl = x[rows, (lv.long() - 1).clamp(0, s - 1)][:, None]
        logits = _logits(params, cfg, xl)[:, 0]
        cache["pos"] = lv.clone()
    return logits, cache


def prefill_chunk(params: dict, cfg: ModelConfig, tokens, cache: dict,
                  start: int, lengths, last_logits):
    """One chunk of an incremental prefill over a scratch dense cache.

    ``tokens``: [B, C] chunk at positions [start, start+C) (``start`` a
    host int); ``cache``: {"k", "v"} scratch [L, B, S_bucket, KVH, Dh]
    carrying earlier chunks' K/V, written in place; ``lengths``: [B] true
    prompt lengths; ``last_logits``: [B, V] carried last-position logits,
    updated for rows whose final prompt token falls inside this chunk.
    Returns (last_logits', cache). The dense family only (``check_supported``
    refuses the others)."""
    check_supported(cfg)
    b, c = tokens.shape
    dev = tokens.device
    lengths = torch.as_tensor(lengths, device=dev).long().expand(b)
    x = _embed_tokens(params, cfg, tokens)
    layers = zip(layers_of(params["layers"], cfg.num_layers),
                 cache["k"].unbind(0), cache["v"].unbind(0))
    for p_l, k_l, v_l in layers:
        x, _, _ = blocks.attn_block_prefill_chunk(p_l, cfg, x, k_l, v_l,
                                                  start)
    x = norms.apply(params["final_norm"], x, cfg.norm_eps)
    # rows whose last prompt token lives in this chunk pick up their logits
    idx = (lengths - 1 - start).clamp(0, c - 1)
    rows = torch.arange(b, device=dev)
    sel = _logits(params, cfg, x[rows, idx][:, None])[:, 0]
    hit = (lengths - 1 >= start) & (lengths - 1 < start + c)
    last_logits = torch.where(hit[:, None], sel.to(last_logits.dtype),
                              last_logits)
    return last_logits, cache


# --------------------------------------------------------------- insertion


def insert_slots(cache: dict, src: dict, slots) -> dict:
    """Write the rows of ``src`` (a cache of batch size n from a prefill)
    into ``cache`` at slot indices ``slots`` ([n]); rows whose slot is out
    of range (admission padding) are dropped."""
    dev = cache["pos"].device
    num_slots = cache["pos"].shape[0]
    slots = torch.as_tensor(slots, device=dev).long()
    keep = slots < num_slots
    idx = slots[keep]
    cache["pos"][idx] = src["pos"][keep].to(cache["pos"].dtype)
    for key in ("k", "v"):
        cache[key][:, idx] = src[key][:, keep].to(cache[key].dtype)
    return cache


def insert_slots_paged(cache: dict, src: dict, slots, lengths,
                       starts=None) -> dict:
    """Scatter a dense prefill cache (``src``: k/v [L, n, S, KVH, Dh]) into
    the page pools through ``cache["pages"]``. ``slots``: [n] slot per row
    (entries == num_slots are admission padding and drop); ``lengths``: [n]
    true prompt lengths — positions >= length drop, so bucket-pad garbage
    never reaches a live page. Writes through sentinel table entries drop.
    ``starts`` (optional, [n] or a scalar): first position to write per row
    — positions below it also drop, which is the prefix cache's rule: table
    entries below ``start`` map to pages shared read-only with other slots
    (or the radix tree) and are never written through. Dropped writes go to
    the sink page (see ``init_paged_cache``)."""
    k_pool, v_pool = cache["k"], cache["v"]
    dev = k_pool.device
    sink, ps = k_pool.shape[1] - 1, k_pool.shape[2]
    num_slots, maxp = cache["pages"].shape
    slots = torch.as_tensor(slots, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    s_max = src["k"].shape[2]
    valid_slot = slots < num_slots
    tbl = cache["pages"][slots.clamp(max=num_slots - 1)].long()
    t = torch.arange(s_max, device=dev)
    page = tbl[:, (t // ps).clamp(max=maxp - 1)]                # [n, s_max]
    ok = (valid_slot[:, None] & (t[None, :] < lengths[:, None])
          & (t[None, :] // ps < maxp) & (page < sink))
    if starts is not None:
        starts = torch.as_tensor(starts, device=dev).long().expand_as(lengths)
        ok = ok & (t[None, :] >= starts[:, None])
    page = torch.where(ok, page, sink)
    off = (t % ps).expand_as(page)
    k_pool[:, page, off] = src["k"].to(k_pool.dtype)
    v_pool[:, page, off] = src["v"].to(v_pool.dtype)
    cache["pos"][slots[valid_slot]] = lengths[valid_slot].to(torch.int32)
    return cache


# --------------------------------------------------------------- decode


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: dict):
    """tokens [B, 1] -> (logits [B, V], cache). Each row attends over and
    writes at its own ``cache["pos"]``; the cache is updated in place and
    ``pos`` advances by one. A cache with ``pages`` is the paged layout, and
    its attention goes through the paged decode kernel; the dense layout's
    goes through the dense decode kernel (``attention.apply_decode``)."""
    b = tokens.shape[0]
    pos = cache["pos"].long().expand(b)
    x = _embed_tokens(params, cfg, tokens)
    layers = zip(layers_of(params["layers"], cfg.num_layers),
                 cache["k"].unbind(0), cache["v"].unbind(0))
    if "pages" in cache:
        sink, ps = cache["k"].shape[1] - 1, cache["k"].shape[2]
        step = attention.paged_step(cfg, cache["pages"], pos, sink, ps,
                                    x.dtype)
        for p_l, k_l, v_l in layers:
            x, _, _ = blocks.attn_block_decode_paged(p_l, cfg, x, k_l, v_l,
                                                     step)
    else:
        step = attention.dense_step(cfg, pos, cache["k"].shape[2], x.dtype)
        for p_l, k_l, v_l in layers:
            x, _, _ = blocks.attn_block_decode(p_l, cfg, x, k_l, v_l, step)
    x = norms.apply(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, 0]
    cache["pos"] = (pos + 1).to(torch.int32)
    return logits, cache
