"""Discrete distributions for table-driven sampling.

Equivalent of ``mi.DiscreteDistribution`` used by the reference's
hidden-geometry sampling (area-proportional shape selection,
/root/reference/mitransient/integrators/transientnlospath.py:277-292).

Design choice: branchless binary search over the inclusive-CDF — a fixed
``ceil(log2(n))`` iteration loop of gathers, fully vectorized over lanes and
friendly to XLA (static trip count, no data-dependent control flow).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp


class DiscreteDistribution(NamedTuple):
    pmf: jnp.ndarray  # (n,) normalized probabilities
    cdf: jnp.ndarray  # (n,) inclusive cumulative sum (last element == 1)
    total: jnp.ndarray  # () original (unnormalized) sum

    @staticmethod
    def from_weights(w: jnp.ndarray) -> "DiscreteDistribution":
        w = jnp.asarray(w, jnp.float32)
        total = jnp.sum(w)
        pmf = w / jnp.maximum(total, 1e-30)
        cdf = jnp.cumsum(pmf)
        return DiscreteDistribution(pmf, cdf, total)

    @property
    def n(self) -> int:
        return self.pmf.shape[0]

    def sample(self, u: jnp.ndarray) -> jnp.ndarray:
        """Inverse-CDF sample; u in [0,1) shape (...,) -> int32 indices."""
        n = self.n
        steps = max(1, math.ceil(math.log2(max(n, 2))))
        lo = jnp.zeros(u.shape, jnp.int32)
        hi = jnp.full(u.shape, n - 1, jnp.int32)
        for _ in range(steps):
            mid = (lo + hi) // 2
            c = self.cdf[mid]
            go_right = u > c
            lo = jnp.where(go_right, mid + 1, lo)
            hi = jnp.where(go_right, hi, mid)
        return jnp.clip(lo, 0, n - 1)

    def sample_pmf(self, u: jnp.ndarray):
        idx = self.sample(u)
        return idx, self.pmf[idx]

    def sample_reuse(self, u: jnp.ndarray):
        """Sample an index and rescale ``u`` to a fresh uniform in [0,1)."""
        idx = self.sample(u)
        cdf_lo = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
        p = self.pmf[idx]
        u2 = jnp.clip((u - cdf_lo) / jnp.maximum(p, 1e-30), 0.0, 1.0 - 1e-7)
        return idx, u2, p
