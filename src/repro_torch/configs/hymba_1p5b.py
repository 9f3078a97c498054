"""Hymba 1.5B — hybrid: parallel attention + mamba heads; SWA on attention (full-cache global layers omitted in this config — window bounds decode state)
Source: arXiv:2411.13676
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='hymba-1.5b',
    family='hybrid',
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    hybrid=True,
    ssm_state=16,
    window=1024,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name='hymba-smoke',
    family='hybrid',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    hybrid=True,
    ssm_state=4,
    window=16,
    tie_embeddings=True,
)
