"""Decoder-only language model, dense family (port of the dense half of the
JAX package's ``models/lm.py``: init, the training forward, prefill,
caches, slot insertion and decode).

Parameters keep the reference tree: the same key names, and the transformer
blocks STACKED under ``"layers"`` with a leading [L] axis, so parameters
convert one to one (``convert.py``) and kernels see the same rows. The
reference's ``lax.scan`` over layers is a Python loop over that axis.

``batch``: {"tokens": [B, S] int tensor}, and for packed SFT batches also
``segment_ids`` and ``positions`` [B, S] int32. Caches are dicts of
tensors and are updated in place by ``decode_step`` and the
``insert_slots*`` functions.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
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


def init(cfg: ModelConfig, generator: torch.Generator | None = None, *,
         device="cuda") -> dict:
    """Random parameters with the reference's shapes and scales (normal
    weights, zero biases, unit norm scales), drawn from ``generator`` (a
    generator on ``device``; default: seed 0) in a fixed key order."""
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
        w = torch.randn(shape, generator=generator, device=dev)
        return (w * how).to(dt)

    def walk(t):
        return {k: (make(*v) if _is_spec(v) else walk(v))
                for k, v in t.items()}
    return walk(param_specs(cfg))


def layer_params(stacked: dict, i: int) -> dict:
    """Block ``i``'s parameters: index the leading [L] axis of every leaf."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


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


def _unbind(tree: dict) -> dict:
    """Each stacked leaf as a tuple of its layers (one ``unbind`` a leaf)."""
    return {k: (_unbind(v) if isinstance(v, dict) else torch.unbind(v, 0))
            for k, v in tree.items()}


def _layer(unbound: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in unbound.items()}


def scan_stack(cfg: ModelConfig, apply_fn, x, stacked: dict):
    """``apply_fn(params_l, x) -> x`` over the layers of a stacked group,
    in order (the reference's ``lax.scan``). Each leaf is split into its
    layers by one ``unbind`` outside the checkpointed function: its backward
    stacks the layers' gradients once, where indexing ``w[i]`` per layer
    would write a full [L, ...] zero tensor for every layer."""
    unbound = _unbind(stacked)
    body = _remat(apply_fn, cfg)
    for i in range(cfg.num_layers):
        x = body(_layer(unbound, i), x)
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


def apply_train(params: dict, cfg: ModelConfig, batch: dict):
    """-> (logits [B, S, V] aligned to batch["tokens"], aux_loss, extra).
    Dense family; ``aux_loss`` is a 0-d f32 zero and ``extra`` empty, as
    the reference gives for it. Packed SFT batches also carry
    ``segment_ids`` [B, S] (0 = pad) and ``positions`` [B, S] (reset at
    each segment): attention is block-diagonal over segments and RoPE sees
    each example at its unpacked positions, so the packed forward equals
    running every segment as its own row. The reference's gated weight
    gradients (``masks``) are not ported."""
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

    x = scan_stack(cfg, block, x, params["layers"])
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
    for i in range(cfg.num_layers):
        x, (k, v) = blocks.attn_block_prefill(
            layer_params(params["layers"], i), cfg, x, cache_len=max_len)
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


def insert_slots_paged(cache: dict, src: dict, slots, lengths) -> dict:
    """Scatter a dense prefill cache (``src``: k/v [L, n, S, KVH, Dh]) into
    the page pools through ``cache["pages"]``. ``slots``: [n] slot per row
    (entries == num_slots are admission padding and drop); ``lengths``: [n]
    true prompt lengths — positions >= length drop, so bucket-pad garbage
    never reaches a live page. Writes through sentinel table entries drop.
    Dropped writes go to the sink page (see ``init_paged_cache``)."""
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
    its attention goes through the paged decode kernel."""
    b = tokens.shape[0]
    pos = cache["pos"].long().expand(b)
    x = _embed_tokens(params, cfg, tokens)
    if "pages" in cache:
        sink, ps = cache["k"].shape[1] - 1, cache["k"].shape[2]
        step = attention.paged_step(cfg, cache["pages"], pos, sink, ps)
        for i in range(cfg.num_layers):
            x, _, _ = blocks.attn_block_decode_paged(
                layer_params(params["layers"], i), cfg, x, cache["k"][i],
                cache["v"][i], step)
    else:
        for i in range(cfg.num_layers):
            x, _, _ = blocks.attn_block_decode(
                layer_params(params["layers"], i), cfg, x, cache["k"][i],
                cache["v"][i], pos)
    x = norms.apply(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, 0]
    cache["pos"] = (pos + 1).to(torch.int32)
    return logits, cache
