"""Smoke run of the transient renderer on one GPU, at full size.

    python chip_smoke.py           # one card, all phases
    python chip_smoke.py --four    # four cards: sharded render + backward only

Drives the main path through the entry points a user calls
(``mitr.load_dict`` -> ``mitr.render``, ``mitr.render_backward``,
``mitr.nlos.*``) and checks what comes out.  Every phase prints one line;
a failed phase prints its traceback to stderr, the run goes on to the next
phase and exits non-zero at the end without the final line.  The last line
of a run in which every phase passed is the JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.

Phases (one card): device, kernels (the Triton-route intersection kernels
against XLA's jnp sweeps at 2^21 rays), goldens + oracle, cbox render
(256x256 px, 300 bins, max_depth 8, spp 1024), NLOS capture (32x32 scan,
300 bins, spp 2048), gradient steps (three ``render_backward`` steps on the
256x256x300 cbox at spp 64), memory, and the ``chip``-marked tests.

The run needs a GPU: without one JAX reports another platform and the run
fails in its first phase.  It uses one JAX process per card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.device import card, require_gpu  # noqa: E402

N_RAYS = 1 << 21  # one wavefront of the cbox's regen loop (render.py)
CBOX_SPP = 1024  # bench.py's cbox workload
NLOS_SPP = 2048  # bench.py's NLOS workload
GRAD_SPP = 64


def _timed(fn, *args, reps=5):
    """Median wall seconds of ``fn(*args)`` (warm), each call synced with
    ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def _triangle_sets():
    import mitransient_tpu as mitr

    def tri(scene):
        t = scene.data.tri
        return tuple(np.asarray(a, np.float32) for a in (t.v0, t.e1, t.e2))

    # 64x64 quad grid on z=0 -> 8192 triangles
    n = 64
    xs = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    x0, y0 = np.meshgrid(xs[:-1], xs[:-1], indexing="ij")
    h = xs[1] - xs[0]
    a = np.stack([x0, y0, np.zeros_like(x0)], -1).reshape(-1, 3)
    ex = np.tile([h, 0.0, 0.0], (a.shape[0], 1)).astype(np.float32)
    ey = np.tile([0.0, h, 0.0], (a.shape[0], 1)).astype(np.float32)
    grid = (np.concatenate([a, a + ex + ey]),
            np.concatenate([ex, -ex]), np.concatenate([ey, -ey]))
    return {
        "cbox": tri(mitr.load_dict(mitr.cornell_box())),
        "nlos": tri(mitr.load_dict(mitr.utils.nlos_scene(sx=32, sy=32))),
        "grid8192": grid,
    }


def _rays(name, rng):
    n = N_RAYS
    if name == "cbox":  # inside the box, every direction: all rays hit
        o = rng.uniform(-0.95, 0.95, (n, 3))
    elif name == "nlos":  # between relay wall and hidden target: many miss
        o = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(0.05, 0.95, n)], -1)
    else:  # above the grid
        o = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.2, 2.0, n)], -1)
    d = rng.normal(size=(n, 3))
    if name == "grid8192":
        d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.1, 3.0, n))
    active = rng.uniform(size=n) < 0.9
    return (o.astype(np.float32), d.astype(np.float32),
            maxt.astype(np.float32), active)


def _mt64(v0, e1, e2, o, d):
    """Float64 Möller–Trumbore of one ray against triangles -> (t, u, v)."""
    v0, e1, e2, o, d = (np.asarray(x, np.float64) for x in (v0, e1, e2, o, d))
    p = np.cross(d, e2)
    det = np.sum(e1 * p, -1)
    inv = 1.0 / np.where(det != 0, det, 1.0)
    tv = o - v0
    u = np.sum(tv * p, -1) * inv
    q = np.cross(tv, e1)
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    return t, u, v


def _borderline(t, u, v, maxt, cos):
    """A float64 hit that float32 may decide either way: on a triangle edge,
    at the ray's maxt, or at the self-intersection epsilon, each within the
    t bar of ``_t_rtol``."""
    from mitransient_tpu.ops.intersect import RAY_EPS

    tol = _t_rtol(cos)
    edge = np.minimum(np.minimum(u, v), 1.0 - u - v)
    return ((np.abs(edge) < tol) & (t > 0)) | (
        np.abs(t - maxt) <= tol * np.abs(t)) | (np.abs(t - RAY_EPS) <= tol)


def _cos_incidence(tris, d, prim):
    """|cos| of the angle between each ray and its hit triangle's normal."""
    _v0, e1, e2 = (np.asarray(x, np.float64) for x in tris)
    n = np.cross(e1[prim], e2[prim])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.abs(np.sum(np.asarray(d, np.float64) * n, -1))


def _t_rtol(cos):
    """The t bar: 1e-5 relative.  Möller–Trumbore's t loses digits as
    1/|cos| of the incidence angle, so hits more grazing than |cos| = 0.05
    get that much more room."""
    return 1e-5 * np.maximum(1.0, 0.05 / np.maximum(cos, 1e-12))


def _unexplained(tris, rays, idx, occlusion):
    """Count rays in ``idx`` on which kernel and reference disagree for a
    reason other than an exact tie: each such ray must see, in float64, a
    triangle whose hit is borderline (``_borderline``) -- for a closest-hit
    disagreement also two different triangles at the same distance (a shared
    edge, 1e-5 relative)."""
    v0, e1, e2 = tris
    o, d, maxt, _active = rays
    bad = 0
    for i in idx:
        t, u, v = _mt64(v0, e1, e2, o[i], d[i])
        cos_all = _cos_incidence(tris, np.broadcast_to(d[i], v0.shape),
                                 np.arange(v0.shape[0]))
        tol = _t_rtol(cos_all)
        inside = (u >= -tol) & (v >= -tol) & (u + v <= 1 + tol) & (t > 0)
        near = inside & (t <= maxt[i] * (1 + tol))
        if _borderline(t, u, v, maxt[i], cos_all)[near].any():
            continue
        if not occlusion:  # two triangles at the nearest distance: a tie
            order = np.nonzero(near)[0][np.argsort(t[near])]
            if order.size >= 2:
                t0, t1 = t[order[0]], t[order[1]]
                if t1 - t0 <= _t_rtol(cos_all[order[:2]].min()) * t0:
                    continue
        bad += 1
    return bad


def phase_kernels():
    from mitransient_tpu.ops.intersect import (intersect_soup,
                                               ray_test_soup)
    from mitransient_tpu.ops.intersect_triton import (closest_hit_triton,
                                                      ray_test_triton)

    def soup_closest(*a, tri_chunk=32):
        t, p, _u, _v = intersect_soup(*a, tri_chunk=tri_chunk)
        return t, p

    rng = np.random.default_rng(0)
    lines = []
    for name, tris in _triangle_sets().items():
        rays = _rays(name, rng)
        args = tuple(jnp.asarray(x) for x in tris + rays)
        t_r, p_r = (np.asarray(x) for x in soup_closest(*args))
        t_k, p_k = (np.asarray(x) for x in closest_hit_triton(*args))
        occ_r = np.asarray(ray_test_soup(*args))
        occ_k = np.asarray(ray_test_triton(*args))
        same = p_r == p_k
        both = same & (p_r >= 0)
        rel = np.abs(t_k[both] - t_r[both]) / np.abs(t_r[both])
        assert np.isinf(t_k[p_k < 0]).all() and np.isinf(t_r[p_r < 0]).all()
        cos = _cos_incidence(tris, rays[1][both], p_r[both])
        assert (rel <= _t_rtol(cos)).all(), (name, rel.max())
        diff = np.nonzero(~same)[0]
        occ_diff = np.nonzero(occ_r != occ_k)[0]
        bad = (_unexplained(tris, rays, diff, occlusion=False),
               _unexplained(tris, rays, occ_diff, occlusion=True))
        assert bad == (0, 0), (name, bad, diff.size, occ_diff.size)
        m = tris[0].shape[0]
        times = {
            "kernel_closest": _timed(closest_hit_triton, *args),
            "xla_closest": _timed(soup_closest, *args),
            "kernel_anyhit": _timed(ray_test_triton, *args),
            "xla_anyhit": _timed(ray_test_soup, *args),
        }
        if m <= 64:
            dense = jax.jit(lambda *a: soup_closest(*a, tri_chunk=m))
            times["xla_closest_one_chunk"] = _timed(dense, *args)
        lines.append(
            f"{name}: M={m} N={N_RAYS} hits={int((p_r >= 0).sum())} "
            f"prim_ties={diff.size} anyhit_ties={occ_diff.size} "
            f"max_rel_t(|cos|>=0.05)={rel[cos >= 0.05].max(initial=0.0):.2e} "
            + " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in times.items()))
    return "; ".join(lines)


# ---------------------------------------------------------------------------
# phase 3: goldens + oracle
# ---------------------------------------------------------------------------

# Tolerances for re-rendering the committed CPU goldens on the card.  Same
# seed, same counter-based sample stream, so the estimator runs the same
# paths; GPU transcendentals, FMA contraction and atomic scatter order differ
# from the CPU's in the last bits (~1e-6 relative per value).  A last-bit
# difference can flip a discrete choice (Russian roulette, a free-flight
# distance, a bin boundary, a hit on an edge), which moves one path's whole
# contribution in ONE pixel; at these tiny spp one path is a sizeable part
# of a pixel.  So: total energy within 1e-3 relative, and every pixel within
# 1e-3 relative except at most GOLDEN_FLIPPED_PIXELS or 1% of the pixels,
# whichever is more (a handful of flips; the energy bound caps their sum).
GOLDEN_ENERGY_RTOL = 1e-3
GOLDEN_PIXEL_RTOL = 1e-3
GOLDEN_FLIPPED_PIXELS = 4


def _golden_check(got, want):
    """-> (energy rel diff, pixels off by more than GOLDEN_PIXEL_RTOL,
    pixels allowed off)."""
    scale = float(np.abs(want).max()) or 1.0
    e_got, e_want = float(got.sum()), float(want.sum())
    e_rel = abs(e_got - e_want) / max(abs(e_want), 1e-30)
    if got.ndim >= 3:  # images: per-pixel totals over the trailing axes
        g = got.reshape(got.shape[0] * got.shape[1], -1).sum(-1)
        w = want.reshape(want.shape[0] * want.shape[1], -1).sum(-1)
    else:  # gradient tables: per entry
        g, w = got.ravel(), want.ravel()
    off = np.abs(g - w) > GOLDEN_PIXEL_RTOL * np.abs(w) + 1e-6 * scale
    allowed = max(GOLDEN_FLIPPED_PIXELS, int(0.01 * off.size))
    return e_rel, int(off.sum()), allowed


def phase_goldens_oracle():
    import golden_configs
    import test_oracle

    rows, bad = [], []
    for name, fn in sorted(golden_configs.WORKLOADS.items()):
        want = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        got = fn()
        assert set(got) == set(want.files), name
        for k in sorted(got):
            assert got[k].shape == want[k].shape, (name, k)
            e_rel, n_off, allowed = _golden_check(got[k], want[k])
            rows.append(f"{name}:{k} E{e_rel:.1e}/off{n_off}")
            if e_rel > GOLDEN_ENERGY_RTOL or n_off > allowed:
                bad.append(rows[-1])
    print("  goldens " + " ".join(rows), flush=True)
    assert not bad, bad
    # the float64 quadrature oracle, with the oracle tests' own tolerances
    import mitransient_tpu as mitr

    s, t = mitr.render(mitr.load_dict(test_oracle.oracle_scene()), spp=4096,
                       seed=3)
    one = (np.asarray(s, np.float64), np.asarray(t, np.float64))
    test_oracle.test_steady_absolute_radiometry(one)
    test_oracle.test_transient_bin_oracle(one)
    s, t = mitr.render(mitr.load_dict(test_oracle.two_bounce_scene()),
                       spp=4096, seed=5)
    two = (np.asarray(s, np.float64), np.asarray(t, np.float64))
    test_oracle.test_two_bounce_steady_radiometry(two)
    test_oracle.test_two_bounce_transient_bins(two)
    test_oracle.test_emitter_radiance_invariance()
    test_oracle.test_prb_gradient_exact_linearity()
    return (f"{len(golden_configs.WORKLOADS)} goldens within energy "
            f"{GOLDEN_ENERGY_RTOL} and <= max({GOLDEN_FLIPPED_PIXELS}, 1%) "
            f"pixels off by > {GOLDEN_PIXEL_RTOL}; oracle: direct + "
            "two-bounce radiometry, bins, radiance invariance, PRB linearity "
            "within the oracle tests' tolerances")


# ---------------------------------------------------------------------------
# phases 4-6: full-size renders
# ---------------------------------------------------------------------------

def _render_timed(scene, spp, **kw):
    """Warm (compile) render, then one timed render with another seed."""
    import mitransient_tpu as mitr

    t0 = time.perf_counter()
    jax.block_until_ready(mitr.render(scene, spp=spp, seed=0, **kw))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    s, t, stats = mitr.render(scene, spp=spp, seed=1, return_stats=True, **kw)
    jax.block_until_ready((s, t))
    wall = time.perf_counter() - t0
    return np.asarray(s), np.asarray(t), float(stats["rays"]), wall, first


def phase_cbox():
    import mitransient_tpu as mitr

    scene = mitr.load_dict(mitr.cornell_box())
    film = scene.sensors[0].film
    h, w, nb = film.height, film.width, film.temporal_bins
    st, tr, rays, wall, first = _render_timed(scene, CBOX_SPP)
    assert st.shape == (h, w, 3) and tr.shape == (h, w, nb, 3)
    assert np.isfinite(st).all() and np.isfinite(tr).all()
    prof = tr.sum(axis=(0, 1, 3))
    first_bin = int(np.nonzero(prof)[0][0])
    ratio = float(tr.sum() / st.sum())
    left, right = st[h // 2, w * 6 // 256], st[h // 2, w * 249 // 256]
    # first arrival = camera -> emitter distance; transient energy is the
    # steady energy minus what falls past the last bin
    assert 15 <= first_bin <= 18, first_bin
    assert 0.9 < ratio <= 1.0001, ratio
    assert left[0] > left[1] and right[1] > right[0], (left, right)
    return (f"{w}x{h}x{nb} spp {CBOX_SPP}: {rays / wall / 1e6:.2f} Mrays/s "
            f"({rays:.4g} rays in {wall:.3f}s; first call {first:.1f}s), "
            f"first bin {first_bin}, transient/steady {ratio:.5f}, "
            "red left / green right")


def phase_nlos():
    import mitransient_tpu as mitr

    scene = mitr.load_dict(mitr.utils.nlos_scene(sx=32, sy=32))
    mitr.nlos.focus_emitter_at_relay_wall_pixel([16.0, 16.0], scene)
    st, tr, rays, wall, first = _render_timed(scene, NLOS_SPP)
    assert tr.shape == (32, 32, 300, 3), tr.shape
    assert np.isfinite(tr).all() and tr.sum() > 0.0
    first_bin = int(np.nonzero(tr.sum(axis=(0, 1, 3)))[0][0])
    # wall -> hidden target (z = 1) -> wall is at least 2.0 OPL: bin >= 100
    assert 90 <= first_bin <= 115, first_bin
    return (f"32x32x300 spp {NLOS_SPP}: {rays / wall / 1e6:.2f} Mrays/s "
            f"({rays:.4g} rays in {wall:.3f}s; first call {first:.1f}s), "
            f"first bin {first_bin}")


def phase_gradient():
    """Three steps of examples/diff_transient/optimize_reflectance.py at
    full film size: recover the white wall's reflectance by Adam on the L2
    transient loss."""
    import optax

    import mitransient_tpu as mitr

    d = mitr.cornell_box()
    d["sensor"]["film"]["start_opl"] = 0.0
    d["sensor"]["film"]["bin_width_opl"] = (
        8.0 / d["sensor"]["film"]["temporal_bins"])
    d["integrator"]["max_depth"] = 4
    scene = mitr.load_dict(d)
    path = "white.reflectance.value"
    params = mitr.traverse(scene)
    true_val = np.asarray(params[path]).copy()
    spp = GRAD_SPP
    # one fixed seed throughout (the example's --quick pattern): the loss is
    # then a deterministic function of theta, so every step must descend
    _s, target = mitr.render(scene, spp=spp, seed=0, regenerate=False)
    target = np.asarray(target)
    theta = np.array([0.15, 0.6, 0.25], np.float32)
    opt = optax.adam(5e-2)
    opt_state = opt.init(theta)
    err0 = np.abs(theta - true_val)
    walls = []
    for it in range(3):
        params[path] = theta
        params.update()
        t0 = time.perf_counter()
        _s, img = mitr.render(scene, spp=spp, seed=0, regenerate=False)
        img = np.asarray(img)
        grad_in = (2.0 / target.size) * (img - target)
        grads = mitr.render_backward(
            scene, (None, grad_in.astype(np.float32)), spp=spp, seed=0)
        g = np.asarray(grads[path])
        walls.append(time.perf_counter() - t0)
        assert np.isfinite(g).all() and np.abs(g).sum() > 0.0, g
        updates, opt_state = opt.update(g, opt_state)
        theta = np.clip(theta + np.asarray(updates), 0.0, 1.0)
    err = np.abs(theta - true_val)
    # every component starts >= 0.09 from the truth and Adam's first steps
    # move each by ~lr against the gradient's sign: all must move closer
    assert (err < err0).all(), (err0, err)
    return (f"3 steps, cbox film, spp {spp}: step walls "
            + ", ".join(f"{w:.2f}s" for w in walls)
            + f" (first includes compile); |theta-true| {err0.max():.3f}"
            f" -> {err.max():.3f}")


# ---------------------------------------------------------------------------
# phase 7: memory
# ---------------------------------------------------------------------------

def phase_memory():
    import mitransient_tpu as mitr
    from mitransient_tpu.film.transient_film import film_init_any
    from mitransient_tpu.render import DEFAULT_MAX_LANES, _regen_render
    from mitransient_tpu.scene.scene import primal_sd
    from mitransient_tpu.sensors.perspective import build_camera

    scene = mitr.load_dict(mitr.cornell_box())
    cfg = scene.sensors[0]
    hw = cfg.film.width * cfg.film.height
    film = film_init_any(cfg.film, scene.variant.color_channels)
    compiled = _regen_render.lower(
        primal_sd(scene.data), build_camera(cfg), film, jnp.uint32(0),
        film_cfg=cfg.film, icfg=scene.integrator, spp_total=CBOX_SPP,
        lanes_per_pixel=min(CBOX_SPP, DEFAULT_MAX_LANES // hw),
        polarized=False).compile()
    ma = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    gib = 1 << 30
    return (f"cbox pass: arguments {ma.argument_size_in_bytes / gib:.3f} "
            f"GiB, outputs {ma.output_size_in_bytes / gib:.3f} GiB, temp "
            f"{ma.temp_size_in_bytes / gib:.3f} GiB; process peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 0) / gib:.3f} GiB of "
            f"{stats.get('bytes_limit', 0) / gib:.3f} GiB")


# ---------------------------------------------------------------------------
# phase 8: chip-marked tests
# ---------------------------------------------------------------------------

class _Passes:
    """pytest plugin counting passed tests."""

    def __init__(self):
        self.passed = 0

    def pytest_runtest_logreport(self, report):
        self.passed += report.when == "call" and report.passed


def phase_chip_tests():
    import pytest

    os.environ["MITR_CHIP_TESTS"] = "1"
    count = _Passes()
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_chip.py")],
                     plugins=[count])
    assert rc == 0 and count.passed > 0, (rc, count.passed)
    return f"tests/test_chip.py -m chip: {count.passed} passed"


# ---------------------------------------------------------------------------
# --four: sharded render and backward against one card
# ---------------------------------------------------------------------------

def _peak_gib(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30


def _agree(a, b, what, rel_limit=1e-2, z_limit=5.0):
    """Two independent Monte-Carlo estimates of the same image agree: their
    totals differ by at most ``z_limit`` standard errors, the standard error
    taken from the per-pixel differences themselves (E[(a-b)^2] = 2 var),
    and by at most ``rel_limit`` relative."""
    a = np.asarray(a, np.float64).reshape(a.shape[0] * a.shape[1], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0] * b.shape[1], -1)
    da = a.sum(-1) - b.sum(-1)
    se = float(np.sqrt(np.sum(da * da)))
    diff = float(a.sum() - b.sum())
    rel = abs(diff) / abs(float(b.sum()))
    z = abs(diff) / max(se, 1e-30)
    assert rel <= rel_limit and z <= z_limit, (what, rel, z)
    return rel, z


def run_four():
    import mitransient_tpu as mitr
    from mitransient_tpu.parallel.mesh import (make_mesh,
                                               render_backward_sharded,
                                               render_sharded)

    info = require_gpu()
    assert info["count"] >= 4, info
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    print(card(), flush=True)
    mesh = make_mesh(4)
    scene = mitr.load_dict(mitr.cornell_box())
    spp = CBOX_SPP

    def timed(fn):
        jax.block_until_ready(fn(0))
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(1))
        return out, time.perf_counter() - t0

    (s4, t4), w4 = timed(lambda sd: render_sharded(scene, mesh, spp=spp,
                                                   seed=sd))
    # every card must have held a share of the work, not device 0 alone
    peaks = [_peak_gib(d) for d in jax.devices()[:4]]
    assert min(peaks) > 0.1, peaks
    (s1, t1), w1 = timed(lambda sd: mitr.render(scene, spp=spp, seed=sd))
    s4, t4, s1, t1 = (np.asarray(x) for x in (s4, t4, s1, t1))
    rel_t, z_t = _agree(t4, t1, "transient energy")
    rel_s, z_s = _agree(s4, s1, "steady image")
    print(f"render: sharded 4 cards {w4:.3f}s, one card {w1:.3f}s; "
          f"transient energy {t4.sum():.6g} vs {t1.sum():.6g} (rel "
          f"{rel_t:.2e}, z {z_t:.2f}); steady mean {s4.mean():.6g} vs "
          f"{s1.mean():.6g} (rel {rel_s:.2e}, z {z_s:.2f}); limits rel "
          f"1e-2, z 5; peak GiB per card "
          + ", ".join(f"{p:.2f}" for p in peaks), flush=True)

    ones_t = np.ones(t1.shape, np.float32)

    def table(g):
        return g["__tables__"].bsdf_reflectance

    g4, wb4 = timed(lambda sd: table(render_backward_sharded(
        scene, mesh, (None, ones_t), spp=256, seed=sd)))
    g1, wb1 = timed(lambda sd: table(mitr.render_backward(
        scene, (None, ones_t), spp=256, seed=sd)))
    g4, g1 = np.asarray(g4), np.asarray(g1)
    assert np.isfinite(g4).all() and np.isfinite(g1).all()
    rel_g = float(np.abs(g4 - g1).max() / np.abs(g1).max())
    # the gradient of the total transient energy w.r.t. each BSDF row is a
    # sum over the whole image, so two sample sets agree to MC noise
    assert rel_g <= 2e-2, rel_g
    print(f"backward spp 256: sharded 4 cards {wb4:.3f}s, one card "
          f"{wb1:.3f}s; reflectance-gradient max rel diff "
          f"{rel_g:.2e} (limit 2e-2)", flush=True)
    return info


PHASES = [
    ("kernels", phase_kernels),
    ("goldens+oracle", phase_goldens_oracle),
    ("cbox", phase_cbox),
    ("nlos", phase_nlos),
    ("gradient", phase_gradient),
    ("memory", phase_memory),
    ("chip-tests", phase_chip_tests),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: sharded render + backward vs one card")
    args = ap.parse_args(argv)
    if args.four:
        info = run_four()
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": 4}}), flush=True)
        return 0

    info = require_gpu()
    print(f"[device] platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    print(card(), flush=True)
    failed = []
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            detail = fn()
        except Exception:  # reported, counted, and fails the run below
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
                  flush=True)
            continue
        print(f"[{name}] ok {time.perf_counter() - t0:.1f}s: {detail}",
              flush=True)
    if failed:
        print(f"failed phases: {', '.join(failed)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
