"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1, GQA kv=8, early fusion
Source: hf:meta-llama/Llama-4-Scout-17B-16E (scaled per assignment)
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='llama4-maverick-400b-a17b',
    family='moe',
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    rope_theta=500000.0,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name='llama4-smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    n_experts=8,
    top_k=1,
    moe_d_ff=128,
    tie_embeddings=False,
)
