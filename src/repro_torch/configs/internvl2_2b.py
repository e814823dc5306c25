"""internvl2-2b [vlm] — arXiv:2404.16821 (InternViT stub + InternLM2-1.8B).

LM backbone: 24L d_model=2048 16H GQA(kv=8) d_ff=8192 vocab=92553.
Vision tower is a STUB: input_specs provides InternViT patch features
[B, 256, 1024]; the real LM-side projector (mlp1) is implemented.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, n_patches=256, frontend_dim=1024, attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_patches=8, frontend_dim=32,
    dtype="float32", remat=False, ce_chunk=16,
)
