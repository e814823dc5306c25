"""zamba2-1.2b [hybrid] — arXiv:2411.15242 (HF config).

38 Mamba2 blocks d_model=2048 (ssm_state=64, expand 2, head_dim 64) + one
shared attention block at width 2D (32H x 128) with d_ff=8192, applied every
6 blocks with per-application LoRA; vocab=32000.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="zamba2",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    shared_attn_every=6, attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke", family="zamba2",
    n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=256,
    ssm_state=8, ssm_expand=2, ssm_head_dim=8, shared_attn_every=2,
    dtype="float32", remat=False, ce_chunk=16,
)
