"""Ray / triangle-soup intersection ops.

Replacement for the Embree/OptiX ``scene.ray_intersect`` / ``ray_test``
calls in the reference (mitransient/integrators/transientpath.py:149,
transientnlospath.py:747).

Design: the canonical transient scenes are *small* in triangle count (cornell
box ~ 36 tris, NLOS Z ~ tens) but *huge* in ray count (W*H*spp up to 2^32
lanes, common.py:48).  The right shape for that regime is a dense
all-rays x all-triangles sweep: a branchless Moller-Trumbore with a running
min-t reduction, regular work with no divergence and no BVH pointer chasing.
The jnp sweeps below run a ``lax.scan`` over triangle chunks, which keeps
peak memory at O(N * CHUNK); they are the reference implementation and the
CPU path.  On CUDA :func:`closest_hit` and :func:`ray_test` run the fused
Pallas kernels of ``ops/intersect_triton.py`` instead.  Large meshes use the
same sweep (correct, O(N * M)); a GPU BVH traversal is future work.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_TRI_CHUNK = 32
RAY_EPS = 1e-4


def closest_hit(v0, e1, e2, ray_o, ray_d, maxt, active):
    """Closest-hit query returning only (t, prim); callers rebuild the
    shading record from the triangle tables (scene.ray_intersect).

    The one backend dispatch of the query: chosen when the program is
    lowered, the Triton-route kernel on CUDA and the jnp sweep elsewhere."""
    from .intersect_triton import closest_hit_triton

    def soup(*args):
        t, prim, _u, _v = intersect_soup(*args)
        return t, prim

    return jax.lax.platform_dependent(
        v0, e1, e2, ray_o, ray_d, maxt, active,
        cuda=closest_hit_triton, default=soup)


def ray_test(v0, e1, e2, ray_o, ray_d, maxt, active):
    """Any-hit (shadow ray) query -> (N,) bool occluded; dispatched like
    :func:`closest_hit`."""
    from .intersect_triton import ray_test_triton

    return jax.lax.platform_dependent(
        v0, e1, e2, ray_o, ray_d, maxt, active,
        cuda=ray_test_triton, default=ray_test_soup)


def _pad_tris(v0, e1, e2, chunk):
    m = v0.shape[0]
    pad = (-m) % chunk
    if pad:
        v0 = jnp.concatenate([v0, jnp.zeros((pad, 3), v0.dtype)])
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3), e1.dtype)])
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3), e2.dtype)])
    return v0, e1, e2, m + pad


@partial(jax.jit, static_argnames=("tri_chunk",))
def intersect_soup(
    v0: jnp.ndarray,
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    maxt: jnp.ndarray,
    active: jnp.ndarray,
    tri_chunk: int = DEFAULT_TRI_CHUNK,
):
    """Closest-hit query.

    Args:
      v0, e1, e2: (M, 3) triangle origin + edge vectors (world space).
      ray_o, ray_d: (N, 3); maxt: (N,); active: (N,) bool.
    Returns:
      t: (N,) hit distance (inf on miss), prim: (N,) int32 (-1 on miss),
      u, v: (N,) barycentrics of the hit.
    """
    v0p, e1p, e2p, m = _pad_tris(v0, e1, e2, tri_chunk)
    n_chunks = m // tri_chunk
    v0c = v0p.reshape(n_chunks, tri_chunk, 3)
    e1c = e1p.reshape(n_chunks, tri_chunk, 3)
    e2c = e2p.reshape(n_chunks, tri_chunk, 3)

    n = ray_o.shape[0]
    init = (
        jnp.where(active, maxt, -jnp.inf),  # best_t; inactive lanes accept nothing
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )

    def body(carry, chunk):
        best_t, best_i, best_u, best_v = carry
        cv0, ce1, ce2, base = chunk
        # Moller-Trumbore, broadcast (N, 1, 3) x (1, C, 3) -> (N, C)
        o = ray_o[:, None, :]
        d = ray_d[:, None, :]
        pvec = jnp.cross(d, ce2[None, :, :])
        det = jnp.sum(ce1[None, :, :] * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
        tvec = o - cv0[None, :, :]
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, ce1[None, :, :])
        v = jnp.sum(d * qvec, axis=-1) * inv_det
        t = jnp.sum(ce2[None, :, :] * qvec, axis=-1) * inv_det
        hit = (
            (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > RAY_EPS)
            & (t < best_t[:, None])
        )
        t_masked = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t_masked, axis=-1)
        lane = jnp.arange(n)
        tj = t_masked[lane, j]
        found = jnp.isfinite(tj)
        best_i = jnp.where(found, base + j.astype(jnp.int32), best_i)
        best_u = jnp.where(found, u[lane, j], best_u)
        best_v = jnp.where(found, v[lane, j], best_v)
        best_t = jnp.where(found, tj, best_t)
        return (best_t, best_i, best_u, best_v), None

    bases = (jnp.arange(n_chunks) * tri_chunk).astype(jnp.int32)
    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(
        body, init, (v0c, e1c, e2c, bases)
    )
    miss = best_i < 0
    best_t = jnp.where(miss, jnp.inf, best_t)
    return best_t, best_i, best_u, best_v


@partial(jax.jit, static_argnames=("tri_chunk",))
def ray_test_soup(
    v0: jnp.ndarray,
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    maxt: jnp.ndarray,
    active: jnp.ndarray,
    tri_chunk: int = DEFAULT_TRI_CHUNK,
):
    """Any-hit (shadow ray) query -> (N,) bool occluded."""
    v0p, e1p, e2p, m = _pad_tris(v0, e1, e2, tri_chunk)
    n_chunks = m // tri_chunk
    v0c = v0p.reshape(n_chunks, tri_chunk, 3)
    e1c = e1p.reshape(n_chunks, tri_chunk, 3)
    e2c = e2p.reshape(n_chunks, tri_chunk, 3)
    n = ray_o.shape[0]
    limit = jnp.where(active, maxt, -jnp.inf)

    def body(occluded, chunk):
        cv0, ce1, ce2 = chunk
        o = ray_o[:, None, :]
        d = ray_d[:, None, :]
        pvec = jnp.cross(d, ce2[None, :, :])
        det = jnp.sum(ce1[None, :, :] * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
        tvec = o - cv0[None, :, :]
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, ce1[None, :, :])
        v = jnp.sum(d * qvec, axis=-1) * inv_det
        t = jnp.sum(ce2[None, :, :] * qvec, axis=-1) * inv_det
        hit = (
            (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > RAY_EPS)
            & (t < limit[:, None])
        )
        return occluded | jnp.any(hit, axis=-1), None

    occluded, _ = jax.lax.scan(
        body, jnp.zeros((n,), bool), (v0c, e1c, e2c)
    )
    return occluded & active
