"""Parameters from the JAX package, given as numpy: ``params_from_numpy``.

The reference initialises its weights with ``jax.random``, which PyTorch
cannot replay. A test converts the reference's parameter pytree to nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
hands it here; the stacked ``[L, ...]`` layout is kept, so both packages
compute the same thing on the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


#: ml_dtypes' narrow floats (numpy dtype names) → (the unsigned integer
#: view of their bytes, the torch dtype): ``torch.from_numpy`` takes
#: neither, so their bits travel as integers
_NARROW = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Nested dicts of numpy arrays → the same dicts of tensors on
    ``device`` (copied, contiguous, dtype kept: ml_dtypes' ``bfloat16`` and
    ``float8_e4m3fn`` arrays become bf16 and e4m3 tensors with the same
    bits). Leaves that are not arrays (e.g. the ConvNet's ``"meta"`` ints)
    are kept as they are."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        return tree
    narrow = _NARROW.get(tree.dtype.name)
    if narrow is not None:
        bits = np.ascontiguousarray(tree).view(narrow[0]).copy()
        return torch.from_numpy(bits).view(narrow[1]).to(device)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
