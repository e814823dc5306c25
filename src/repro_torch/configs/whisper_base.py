"""whisper-base [audio] — arXiv:2212.04356 (enc-dec; conv frontend STUB).

6L enc + 6L dec, d_model=512 8H MHA d_ff=2048 vocab=51865, GELU, LayerNorm,
tied decoder embeddings. input_specs provides precomputed frame embeddings
[B, 1500, 512]. max_seq sized for the assigned decode_32k cell (shape-level;
real Whisper caps at 448 decoder positions).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="whisper",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, d_ff=2048,
    vocab_size=51865, norm="layernorm", act="gelu", qkv_bias=True,
    tie_embeddings=True, enc_seq=1500, max_seq=32768, attn_impl="blocked", dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke", family="whisper",
    n_layers=2, n_enc_layers=2, d_model=48, n_heads=4, d_ff=96,
    vocab_size=256, norm="layernorm", act="gelu", qkv_bias=True,
    tie_embeddings=True, enc_seq=16, max_seq=64,
    dtype="float32", remat=False, ce_chunk=16,
)
