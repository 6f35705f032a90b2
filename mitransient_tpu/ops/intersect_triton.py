"""Closest-hit and any-hit triangle-soup sweeps as Pallas kernels on the
Triton route (GPU).

Each program owns ``block`` rays.  Their origin, direction and ``maxt`` are
loaded once and stay in registers while the program walks the whole
triangle table in ``chunk``-triangle slices read from device memory (every
program reads the same rows, so L1/L2 serve them).  Möller–Trumbore runs
with the epsilons of :func:`ops.intersect.intersect_soup` on a
``(block, chunk)`` tile and folds straight into a running ``(t, prim)``
minimum, so none of the ``(N, chunk)`` tiles the jnp sweep materialises is
ever written to device memory.

Ties: within a chunk the lowest triangle index among exact-``t`` ties wins
and a later chunk must be strictly nearer, which is the jnp sweep's
``argmin`` + strict ``<`` rule.

The inputs are detached by the callers (scene.ray_intersect / ray_test), so
the kernels define no AD rule.  ``interpret=True`` runs them on the CPU for
the tests; on the GPU they are compiled, never interpreted.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .intersect import RAY_EPS

# Tile defaults from a sweep on an H100 (block 64-512, chunk 1-32, 2-8 warps;
# cbox 36 triangles and an 8192-triangle grid at 2^21 rays; PERF.md)
BLOCK = 128  # rays per program
CHUNK = 4  # triangles per table slice
NUM_WARPS = 4
_NO_PRIM = 2**31 - 1


def _tri_table(v0, e1, e2, chunk):
    """(9, M_pad) rows v0xyz, e1xyz, e2xyz.  Padding triangles are all-zero:
    their determinant is 0, so they never hit."""
    table = jnp.concatenate([v0.T, e1.T, e2.T]).astype(jnp.float32)
    pad = (-table.shape[1]) % chunk
    if pad:
        table = jnp.pad(table, ((0, 0), (0, pad)))
    return table


def _pad_rays(ray_o, ray_d, limit, block):
    """Pad the ray count to a multiple of ``block``; padded rays get
    ``limit = -inf`` and accept nothing."""
    pad = (-ray_o.shape[0]) % block
    if pad:
        ray_o = jnp.pad(ray_o, ((0, pad), (0, 0)))
        ray_d = jnp.pad(ray_d, ((0, pad), (0, 0)), constant_values=1.0)
        limit = jnp.pad(limit, (0, pad), constant_values=-jnp.inf)
    return ray_o, ray_d, limit


def _mt_hit(tri_ref, k, chunk, ray, best):
    """Möller–Trumbore of ``block`` rays against triangles
    ``[k * chunk, (k + 1) * chunk)`` -> (hit mask, t), both (block, chunk)."""
    s = pl.ds(pl.multiple_of(k * chunk, chunk), chunk)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri_ref[r, s][None, :] for r in range(9))
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in ray)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > RAY_EPS) & (t < best[:, None]))
    return hit, t


def _load_rays(o_ref, d_ref):
    return (o_ref[:, 0], o_ref[:, 1], o_ref[:, 2],
            d_ref[:, 0], d_ref[:, 1], d_ref[:, 2])


def _closest_kernel(tri_ref, o_ref, d_ref, lim_ref, t_ref, prim_ref, *,
                    n_chunks, chunk):
    ray = _load_rays(o_ref, d_ref)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)

    def body(k, carry):
        best_t, best_i = carry
        hit, t = _mt_hit(tri_ref, k, chunk, ray, best_t)
        tm = jnp.where(hit, t, jnp.inf)
        tmin = jnp.min(tm, axis=1)
        idx = jnp.min(
            jnp.where(hit & (tm == tmin[:, None]), k * chunk + lane, _NO_PRIM),
            axis=1)
        found = idx != _NO_PRIM
        return jnp.where(found, tmin, best_t), jnp.where(found, idx, best_i)

    init = (lim_ref[...], jnp.full(lim_ref.shape, -1, jnp.int32))
    best_t, best_i = jax.lax.fori_loop(0, n_chunks, body, init)
    t_ref[...] = jnp.where(best_i < 0, jnp.inf, best_t)
    prim_ref[...] = best_i


def _any_kernel(tri_ref, o_ref, d_ref, lim_ref, occ_ref, *, n_chunks, chunk):
    ray = _load_rays(o_ref, d_ref)
    lim = lim_ref[...]

    def body(k, occ):
        hit, _ = _mt_hit(tri_ref, k, chunk, ray, lim)
        return jnp.maximum(occ, jnp.max(hit.astype(jnp.int32), axis=1))

    occ_ref[...] = jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros(lim_ref.shape, jnp.int32))


def _sweep(kernel, name, out_dtypes, v0, e1, e2, ray_o, ray_d, limit, *,
           block, chunk, num_warps, interpret):
    n = ray_o.shape[0]
    table = _tri_table(v0, e1, e2, chunk)
    ray_o, ray_d, limit = _pad_rays(ray_o.astype(jnp.float32),
                                    ray_d.astype(jnp.float32),
                                    limit.astype(jnp.float32), block)
    n_pad = ray_o.shape[0]
    ray_spec = pl.BlockSpec((block, 3), lambda i: (i, 0))
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    outs = pl.pallas_call(
        functools.partial(kernel, n_chunks=table.shape[1] // chunk,
                          chunk=chunk),
        grid=(n_pad // block,),
        in_specs=[pl.BlockSpec(table.shape, lambda i: (0, 0)),
                  ray_spec, ray_spec, lane_spec],
        out_specs=[lane_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in out_dtypes],
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name=name,
    )(table, ray_o, ray_d, limit)
    return [o[:n] for o in outs]


@functools.partial(jax.jit, static_argnames=("block", "chunk", "num_warps",
                                             "interpret"))
def closest_hit_triton(v0, e1, e2, ray_o, ray_d, maxt, active, *,
                       block=BLOCK, chunk=CHUNK, num_warps=NUM_WARPS,
                       interpret=False):
    """Closest hit -> (t (N,) inf on miss, prim (N,) int32 -1 on miss); the
    (t, prim) contract of ``ops.intersect.intersect_soup``."""
    limit = jnp.where(active, maxt, -jnp.inf)
    t, prim = _sweep(_closest_kernel, "mitr_closest_hit",
                     (jnp.float32, jnp.int32), v0, e1, e2,
                     ray_o, ray_d, limit, block=block, chunk=chunk,
                     num_warps=num_warps, interpret=interpret)
    return t, prim


@functools.partial(jax.jit, static_argnames=("block", "chunk", "num_warps",
                                             "interpret"))
def ray_test_triton(v0, e1, e2, ray_o, ray_d, maxt, active, *,
                    block=BLOCK, chunk=CHUNK, num_warps=NUM_WARPS,
                    interpret=False):
    """Any hit -> (N,) bool occluded; the contract of
    ``ops.intersect.ray_test_soup``."""
    limit = jnp.where(active, maxt, -jnp.inf)
    (occ,) = _sweep(_any_kernel, "mitr_any_hit", (jnp.int32,), v0, e1, e2,
                    ray_o, ray_d, limit, block=block, chunk=chunk,
                    num_warps=num_warps, interpret=interpret)
    return (occ > 0) & active
