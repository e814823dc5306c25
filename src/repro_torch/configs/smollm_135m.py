"""smollm-135m [dense] — hf:HuggingFaceTB/SmolLM-135M (llama arch).

30L d_model=576 9H GQA(kv=3) d_ff=1536 vocab=49152, tied embeddings.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, tie_embeddings=True, attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="smollm-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab_size=256, tie_embeddings=True, dtype="float32", remat=False,
    ce_chunk=16,
)
