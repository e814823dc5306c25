"""minicpm-2b [dense] — arXiv:2404.06395 (WSD schedule; llama-like arch).

40L d_model=2304 36H MHA d_ff=5760 vocab=122753, depth-scaled residuals
(1.4/sqrt(40)), mup logit scaling (256/2304), tied embeddings.
"""
import math

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40), logit_scale=256.0 / 2304.0,
    attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(3), logit_scale=0.5,
    dtype="float32", remat=False, ce_chunk=16,
)
