"""PaliGemma 3B — SigLIP vision frontend is a STUB (input_specs supplies 256 patch embeddings of dim 1152); gemma backbone, MQA kv=1
Source: arXiv:2407.07726
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='paligemma-3b',
    family='vlm',
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    embed_scale=True,
    frontend='vision',
    frontend_seq=256,
    frontend_dim=1152,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name='paligemma-smoke',
    family='vlm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab=128,
    embed_scale=True,
    frontend='vision',
    frontend_seq=8,
    frontend_dim=32,
    tie_embeddings=True,
)
