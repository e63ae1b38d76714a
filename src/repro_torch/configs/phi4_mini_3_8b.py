"""phi4-mini-3.8b: the paper's largest eval model. [hf:microsoft/Phi-4-mini-instruct]
A copy of the JAX package's config of that name, field for field: like it,
it leaves out the published config's partial rotary factor (0.75) and
``longrope`` scaling."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=10000.0,
    pad_heads_to=32, pad_vocab_multiple=16
)

SMOKE = CONFIG.replace(
    pad_heads_to=0, pad_vocab_multiple=1,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
