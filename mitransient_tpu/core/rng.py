"""Counter-based, stateless sample streams.

JAX replacement for Mitsuba's ``independent`` sampler
(consumed by the reference via ``sampler.next_1d()/next_2d()``, e.g.
/root/reference/mitransient/integrators/transientpath.py:193,223-224,256).

Design: every random number is a pure function ``u = U(seed, dimension,
lane)`` of a base seed, a *dimension counter* and the lane index.  This makes
the PRB replay trivially deterministic — the backward sweep re-requests the
exact same dimensions and reproduces the primal path (the property the
reference gets from re-seeding the Dr.Jit sampler between passes,
mitransient/integrators/common.py:371-406) — and it shards cleanly: lanes are
positions inside one ``jax.random`` draw, so a sharded draw is identical to
the unsharded one.

The dimension counter may be a traced int (inside ``lax.fori_loop``):
``jax.random.fold_in`` accepts traced data.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


class Sampler:
    """Per-wavefront independent sampler.

    ``n`` lanes; ``next_1d()`` returns shape ``(n,)`` float32 in [0,1),
    ``next_2d()`` returns ``(n, 2)``.  The object is cheap and immutable-ish:
    the only state is the Python-side dimension counter, which is static under
    tracing as long as the same number of calls happens per trace (true for
    our dense wavefront loops).  For dims that vary inside a traced loop use
    :meth:`at_dim` with a traced offset.
    """

    def __init__(self, seed, n: int, stream: int = 0):
        # Stream separates passes / sensors; seed is the user seed.
        key = jax.random.key(jnp.uint32(seed))
        self.key = jax.random.fold_in(key, jnp.uint32(stream))
        self.n = n
        self.dim = 0

    # -- stateful convenience API (static dimension counter) ------------------
    def next_1d(self) -> jnp.ndarray:
        u = self.eval_1d(self.dim)
        self.dim += 1
        return u

    def next_2d(self) -> jnp.ndarray:
        u = self.eval_2d(self.dim)
        self.dim += 2
        return u

    # -- pure API (explicit, possibly traced, dimension index) ----------------
    def eval_1d(self, dim) -> jnp.ndarray:
        return jax.random.uniform(jax.random.fold_in(self.key, dim), (self.n,))

    def eval_2d(self, dim) -> jnp.ndarray:
        k0 = jax.random.fold_in(self.key, dim)
        k1 = jax.random.fold_in(self.key, dim + 1)
        return jnp.stack(
            [jax.random.uniform(k0, (self.n,)), jax.random.uniform(k1, (self.n,))],
            axis=-1,
        )

    def fork(self, stream: int) -> "Sampler":
        s = Sampler.__new__(Sampler)
        s.key = jax.random.fold_in(self.key, jnp.uint32(stream))
        s.n = self.n
        s.dim = 0
        return s


BOUNCE_STREAM_TAG = 0x42000000  # disambiguates bounce blocks from scalar dims


def draw_bounce_block(key, it, n: int, dims: int):
    """One uniform draw for ALL of a bounce's sampler dimensions: a single
    threefry invocation per bounce instead of ``dims`` separate ones.
    Deterministic in (key, it), so the
    PRB replay regenerates the identical block.  Returns (n, dims)."""
    k = jax.random.fold_in(key, jnp.uint32(BOUNCE_STREAM_TAG) + it)
    return jax.random.uniform(k, (n, dims))
