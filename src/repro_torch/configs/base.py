"""Model configuration: a copy of ``ModelConfig`` from the JAX package's
``configs/base.py`` (field for field, so configs convert one to one and the
tests can build one from the other with ``dataclasses.asdict``).

The port keeps its own copy instead of importing the JAX package. Only the
dense family is served by this slice; the other families' fields stay so the
dataclass matches the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """One config type covering every family in the assigned pool.

    family:
      dense   -- decoder-only transformer (GQA / MHA attention)
      moe     -- decoder-only with mixture-of-experts FFN (optionally MLA attention)
      ssm     -- attention-free Mamba2 (SSD) stack
      hybrid  -- Mamba2 backbone with a single *shared* attention block applied
                 every ``shared_attn_period`` layers (zamba2-style)
      encdec  -- encoder-decoder (seamless-m4t style; frontend stubbed)
      vlm     -- decoder-only backbone consuming a stub vision-patch prefix
    """

    name: str = "unnamed"
    family: str = "dense"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    tie_embeddings: bool = False

    # --- attention variants ---
    attn_bias: bool = False               # qwen-style QKV bias
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0    # chatglm "2d rope" = 0.5
    attn_logit_softcap: float = 0.0       # gemma-style softcap (0 = off)

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert intermediate width
    first_k_dense: int = 0       # deepseek: first k layers use dense FFN
    moe_impl: str = "dense"      # "dense" (oracle; all-experts weighted) | "ep" (shard_map all-to-all)
    ep_axes: tuple = ("model",)  # mesh axes the expert dim shards over
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    mtp_depth: int = 0           # deepseek multi-token-prediction extra blocks
    mtp_loss_weight: float = 0.3

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0  # apply shared attn block after every N ssm layers

    # --- encoder-decoder ---
    num_encoder_layers: int = 0
    frontend_len_ratio: int = 1  # src_len = seq_len // ratio (audio frame downsampling)

    # --- frontend stubs (audio / vision) ---
    frontend: str = ""           # "" | "audio" | "vision"
    num_frontend_tokens: int = 0  # vlm: number of patch-embedding prefix tokens

    # --- TP-alignment padding (exactness-preserving; see models/lm.py) ---
    pad_heads_to: int = 0        # pad q-heads to this count (zero-masked)
    pad_vocab_multiple: int = 1  # pad embed/head rows (logit-bias masked)

    # --- numerics / structure ---
    norm_eps: float = 1e-5
    act: str = "silu"
    dtype: str = "bfloat16"
    remat: str = "full"          # "none" | "full" | "dots"
    logits_softcap: float = 0.0
    use_pallas: str = "auto"     # "auto" | "never" | "always"
    seq_shard_kv: bool = False   # constrain k/v activations S-sharded over
                                 # "model" (stops GSPMD split-contraction
                                 # all-reduces; see EXPERIMENTS.md Perf)
    gate_weight_grads: bool = False  # lax.cond-gated dW for frozen blocks (DESIGN 3.3)
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def quadratic_attention(self) -> bool:
        """True if *prefill/train* cost is quadratic in sequence length and
        there is no sub-quadratic path (used to skip long_500k)."""
        return self.family in ("dense", "encdec", "vlm", "moe")

    @property
    def padded_vocab_size(self) -> int:
        m = max(1, self.pad_vocab_multiple)
        return -(-self.vocab_size // m) * m

    @property
    def padded_heads(self) -> int:
        return max(self.num_heads, self.pad_heads_to)

    @property
    def num_blocks(self) -> int:
        """Paper's block count: embed + transformer blocks + final norm
        (+ shared attn block for hybrids, + encoder blocks for encdec,
        + untied lm head counted with final norm, + MTP blocks)."""
        n = self.num_layers + 2
        if self.family == "hybrid" and self.shared_attn_period:
            n += 1
        if self.family == "encdec":
            n += self.num_encoder_layers + 1   # + enc_norm
        if not self.tie_embeddings:
            n += 1                              # untied lm head
        n += self.mtp_depth
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
