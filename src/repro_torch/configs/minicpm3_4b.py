"""MiniCPM3 4B — MLA (multi-head latent attention): q_rank 768, kv_rank 256
Source: hf:openbmb/MiniCPM3-4B
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='minicpm3-4b',
    family='dense',
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    mla=True,
    q_rank=768,
    kv_rank=256,
    d_nope=64,
    d_rope=32,
    d_v=64,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name='minicpm3-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    mla=True,
    q_rank=32,
    kv_rank=16,
    d_nope=8,
    d_rope=8,
    d_v=8,
    tie_embeddings=True,
)
