"""stablelm-3b [dense] — hf:stabilityai/stablelm-2 family (unverified tier).

32L d_model=2560 32H MHA d_ff=6912 vocab=50304, LayerNorm, partial rotary 25%.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, norm="layernorm", rope_frac=0.25, attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab_size=256, norm="layernorm", rope_frac=0.25,
    dtype="float32", remat=False, ce_chunk=16,
)
