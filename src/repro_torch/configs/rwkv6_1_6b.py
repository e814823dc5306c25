"""rwkv6-1.6b "Finch" [ssm] — arXiv:2404.05892 (unverified tier).

24L d_model=2048 (attn-free; 32 heads x 64), channel-mix d_ff=7168,
vocab=65536, data-dependent decay via LoRA (decay_lora=64, mix_lora=32).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, n_heads=32, d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64, rwkv_decay_lora=64, rwkv_mix_lora=32, dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-smoke", family="rwkv6",
    n_layers=2, d_model=32, n_heads=4, d_ff=96, vocab_size=256,
    rwkv_head_dim=8, rwkv_decay_lora=8, rwkv_mix_lora=4,
    dtype="float32", remat=False, ce_chunk=16,
)
