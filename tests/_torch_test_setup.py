"""Process settings for the port's parity tests, imported first by every
port test file.

One torch thread a process: the tests' tensors are SMOKE-sized, and the
tier-1 run's workers share the machine's cores (six workers of eight torch
threads each left most of them waiting on one another).

One on-disk JAX compilation cache for every worker: the reference's passes
run eagerly, and on the CPU nearly all of their time is XLA compiling each
primitive at each new shape (Mixtral's SMOKE ``certify_lm``: 67 s the first
time, 2 s again in the same process). The SMOKE configs share their widths,
so the test files compile largely the same executables. Every worker
stores what it compiled under ``build/jax_test_cache`` (git-ignored) and
loads what another worker already stored; a loaded executable is the one
the compile would have produced, so no result changes. The cache evicts
nothing, so it takes no lock: two workers storing one key write the same
bytes, and an entry read while it is being written fails to decompress,
which JAX reports as a warning before it compiles the primitive itself.
"""
import os

import jax
import torch
from jax._src import compilation_cache

torch.set_num_threads(1)

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "build", "jax_test_cache")

if not jax.config.jax_compilation_cache_dir:
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # a compile made before the directory was set leaves the cache marked
    # unused for the process; start it afresh
    if not compilation_cache.is_initialized():
        compilation_cache.reset_cache()
