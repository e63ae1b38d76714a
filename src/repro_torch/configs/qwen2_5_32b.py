"""qwen2.5-32b: dense decoder, GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-32B]
A copy of the JAX package's config of that name, field for field: its 40
q heads are padded to 48 (``pad_heads_to``), the 8 padded ones on kv head
7 beside its 5 real ones."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1000000.0,
    pad_heads_to=48, pad_vocab_multiple=16
)

SMOKE = CONFIG.replace(
    pad_heads_to=0, pad_vocab_multiple=1,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
