"""Gemma2 27B — local(4096)/global alternating, logit softcaps, GQA kv=16
Source: arXiv:2408.00118
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='gemma2-27b',
    family='dense',
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    softcap_attn=50.0,
    softcap_final=30.0,
    local_global_period=4096,
    act='gelu',
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name='gemma2-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    softcap_attn=50.0,
    softcap_final=30.0,
    local_global_period=16,
    act='gelu',
    embed_scale=True,
    tie_embeddings=True,
)
