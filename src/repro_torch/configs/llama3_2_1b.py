"""llama3.2-1b: small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B] -- also one of the paper's own eval models.
A copy of the JAX package's config of that name, field for field: like
it, it leaves out the published config's ``llama3`` RoPE scaling."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
    pad_vocab_multiple=16
)

SMOKE = CONFIG.replace(
    pad_heads_to=0, pad_vocab_multiple=1,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
