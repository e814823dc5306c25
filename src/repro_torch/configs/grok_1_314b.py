"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified tier).

64L d_model=6144 48H GQA(kv=8, d_head=128), 8 experts top-2 d_ff=32768,
vocab=131072, attention-logit tanh soft-cap 30.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=0, vocab_size=131072,
    n_experts=8, moe_topk=2, d_ff_expert=32768,
    logits_soft_cap=30.0, attn_impl="blocked", moe_groups=32, dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="grok-1-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=0, vocab_size=256,
    n_experts=4, moe_topk=2, d_ff_expert=64,
    logits_soft_cap=30.0, dtype="float32", remat=False, ce_chunk=16,
)
