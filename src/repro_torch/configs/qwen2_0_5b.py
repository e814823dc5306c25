"""qwen2-0.5b [dense] — arXiv:2407.10671 (HF config).

24L d_model=896 14H GQA(kv=2) d_ff=4864 vocab=151936, QKV bias, tied
embeddings, rope theta 1e6.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0, attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, qkv_bias=True, tie_embeddings=True,
    dtype="float32", remat=False, ce_chunk=16,
)
