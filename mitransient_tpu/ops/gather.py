"""Row lookups of several per-primitive / per-material columns by one index."""
from __future__ import annotations

import jax.numpy as jnp


def columns_lookup(tables: dict, idx: jnp.ndarray) -> dict:
    """Look up several columns by the same index.  ``tables``: name -> (M,)
    or (M, K) arrays.  Returns name -> (N,) or (N, K)."""
    return {k: v[idx] for k, v in tables.items()}
