"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (HF config).

27L d_model=2048 16H MLA(kv_lora=512, qk_nope=128, qk_rope=64, v=128),
64 routed experts top-6 + 2 shared (d_ff_expert=1408), first layer dense
(d_ff=10944), vocab=102400.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, d_ff=0, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64, n_shared_experts=2, moe_topk=6, d_ff_expert=1408,
    first_dense_layers=1, d_ff_dense=10944,
    rope_theta=10_000.0, attn_impl="blocked", moe_groups=32, dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, d_ff=0, vocab_size=256,
    use_mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8, n_shared_experts=2, moe_topk=2, d_ff_expert=32,
    first_dense_layers=1, d_ff_dense=128,
    dtype="float32", remat=False, ce_chunk=16,
)
