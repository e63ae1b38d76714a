"""yi-9b: llama-architecture dense decoder, GQA kv=4. [arXiv:2403.04652]
A copy of the JAX package's config of that name, field for field."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10000.0,
    pad_vocab_multiple=16
)

SMOKE = CONFIG.replace(
    pad_heads_to=0, pad_vocab_multiple=1,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
