"""qwen2.5-0.5b: the paper's primary SLM (25-block count incl. embed/norm).
[hf:Qwen/Qwen2.5-0.5B] A copy of the JAX package's config of that name."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    attn_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    pad_heads_to=16, pad_vocab_multiple=16
)

SMOKE = CONFIG.replace(
    pad_heads_to=0, pad_vocab_multiple=1,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
