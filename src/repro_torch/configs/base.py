"""Configuration: copies of ``ModelConfig``, ``SelectConfig``,
``OptimizerConfig`` and ``TrainConfig`` from the JAX package's
``configs/base.py`` (field for field, with their checks, so configs convert
one to one and the tests can build one from the other with
``dataclasses.asdict``).

The port keeps its own copy instead of importing the JAX package. Only the
dense family runs in the port; the other families' fields, and the
optimizer's residency, offload and LoRA fields, stay so the dataclasses
match the reference (the port raises where they select a path it does not
have yet).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


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


@dataclass(frozen=True)
class SelectConfig:
    """Selection-policy hyper-parameters (paper §3.2 + baseline policies).

    ``policy`` names an entry in the core/adagradselect.py policy registry
    ("adagradselect" | "topk_grad" | "random" | "all" | "lisa" | "grass"),
    validated at lookup, not here."""

    policy: str = "adagradselect"
    k_percent: float = 20.0        # percentage of blocks updated per step
    epsilon0: float = 1.0          # initial exploration rate
    epsilon_decay: float = 0.01    # lambda in eps_t = eps0 * exp(-lambda * t)
    dirichlet_delta: float = 1.0   # smoothing constant delta (alpha = f + delta)
    steps_per_epoch: int = 1000    # after this, epoch>=2 -> pure exploitation
    always_include: tuple = ()     # block indices always selected (e.g. embed)
    lisa_interval: int = 20        # "lisa": steps between mask resamples
    grass_temperature: float = 1.0  # "grass": sampling ∝ cum_norms^T

    def __post_init__(self):
        if not 0.0 < self.k_percent <= 100.0:
            raise ValueError(f"k_percent must be in (0, 100], got "
                             f"{self.k_percent}")
        if self.epsilon0 < 0.0 or self.epsilon_decay < 0.0:
            raise ValueError("epsilon0/epsilon_decay must be >= 0")
        if self.dirichlet_delta <= 0.0:
            raise ValueError("dirichlet_delta must be > 0")
        if self.steps_per_epoch < 1:
            raise ValueError("steps_per_epoch must be >= 1")
        if self.lisa_interval < 1:
            raise ValueError("lisa_interval must be >= 1")
        if self.grass_temperature < 0.0:
            raise ValueError("grass_temperature must be >= 0")

    def num_selected(self, num_blocks: int) -> int:
        # paper guideline: min% >= 100/B  => at least one block per step
        return max(1, int(round(num_blocks * self.k_percent / 100.0)))


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 2e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 20
    schedule: str = "cosine"       # "constant" | "cosine" | "linear"
    total_steps: int = 1000
    # paper 3.3: where the AdamW moments live. "device": full m/v on the
    # card (the dense masked AdamW); "banked": [k]-slot banks on the
    # card over a full store placed by ``offload`` ("host" or "none";
    # "zero1" is ROADMAP Queue A item 11).
    moment_residency: str = "device"  # "device" | "banked"
    offload: str = "none"          # "none" | "host" | "zero1"
    # banked only. Off by default, unlike the reference: the port's
    # synchronous boundary already queues its copies without blocking the
    # host, and the swap planner has yet to earn its staged rows' memory
    # (PERF.md §6, PR 17).
    async_swap: bool = False
    moment_dtype: str = "float32"  # "float32" | "bfloat16" (halves m/v)
    accum_dtype: str = "float32"   # microbatch grad-accumulation buffer
    # LoRA baseline
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # distributed-optimization knobs
    grad_compression: str = "none"  # "none" | "bf16"
    microbatch: int = 0             # >0 -> gradient accumulation over microbatches


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    select: SelectConfig = field(default_factory=SelectConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # fine-tuning method: an entry in the repro_torch.methods registry,
    # validated at Trainer construction
    method: str = "adagradselect"
    seq_len: int = 512
    global_batch: int = 8
    steps: int = 100
    seed: int = 0
    log_every: int = 10
    eval_every: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    checkpoint_keep: int = 3
    straggler_tau: float = 3.0     # abort threshold: step_time > tau * EWMA
