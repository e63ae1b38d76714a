"""chatglm3-6b: dense decoder, GQA kv=2, 2d (partial) RoPE. [arXiv:2406.12793]
A copy of the JAX package's config of that name, field for field."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    partial_rotary_factor=0.5,   # "RoPE 2d": rotary on half the head dim
    rope_theta=10000.0,
    attn_bias=True,              # chatglm uses QKV bias,
    pad_vocab_multiple=16
)

SMOKE = CONFIG.replace(
    pad_heads_to=0, pad_vocab_multiple=1,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
