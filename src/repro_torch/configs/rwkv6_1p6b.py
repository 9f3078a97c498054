"""RWKV6 'Finch' 1.6B — attention-free, data-dependent decay
Source: arXiv:2404.05892
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='rwkv6-1.6b',
    family='ssm',
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    rwkv=True,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name='rwkv6-smoke',
    family='ssm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    rwkv=True,
    tie_embeddings=False,
)
