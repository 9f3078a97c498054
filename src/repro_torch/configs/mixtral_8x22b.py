"""Mixtral 8x22B — MoE 8 experts top-2, GQA kv=8, SWA window
Source: arXiv:2401.04088
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='mixtral-8x22b',
    family='moe',
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    window=4096,
    rope_theta=1000000.0,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name='mixtral-smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    window=16,
    tie_embeddings=False,
)
