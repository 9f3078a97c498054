"""Whisper medium — enc-dec; conv frontend is a STUB (input_specs supplies 1500 frame embeddings); vocab padded 51865 -> 51968 for sharding; decoder context capped at 448 (architectural max)
Source: arXiv:2212.04356
"""
from repro_torch.models.transformer import ArchConfig

FULL = ArchConfig(
    name='whisper-medium',
    family='audio',
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51968,
    act='gelu',
    norm='layernorm',
    enc_dec=True,
    n_enc_layers=24,
    frontend='audio',
    frontend_seq=1500,
    frontend_dim=1024,
    max_decode_seq=448,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name='whisper-smoke',
    family='audio',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=128,
    act='gelu',
    norm='layernorm',
    enc_dec=True,
    n_enc_layers=2,
    frontend='audio',
    frontend_seq=8,
    frontend_dim=64,
    max_decode_seq=16,
    tie_embeddings=True,
)
