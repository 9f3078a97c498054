"""Command-R 35B — dense GQA kv=8, no biases
Source: hf:CohereForAI/c4ai-command-r-v01
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='command-r-35b',
    family='dense',
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab=256000,
    rope_theta=8000000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name='command-r-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    tie_embeddings=True,
)
