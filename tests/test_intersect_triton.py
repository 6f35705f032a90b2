"""The Triton-route intersection kernels (ops/intersect_triton.py) in
interpret mode against the jnp sweeps, the one dispatch that chooses
between them, and what the card's numbers depend on: HIGHEST precision on
every matrix product of a render, the compile-cache location, and a smoke
script that refuses to run without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitransient_tpu.ops.intersect import (closest_hit, intersect_soup,
                                           ray_test, ray_test_soup)
from mitransient_tpu.ops.intersect_triton import (closest_hit_triton,
                                                  ray_test_triton)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(m, n, seed, miss=False, masked=False):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    e1 = rng.uniform(-0.7, 0.7, (m, 3)).astype(np.float32)
    e2 = rng.uniform(-0.7, 0.7, (m, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    # aim at a point inside a random triangle (or away from it)
    k = rng.integers(0, m, n)
    a, b = rng.uniform(0.05, 0.45, (2, n, 1))
    target = v0[k] + a * e1[k] + b * e2[k]
    d = (o - target) if miss else (target - o)
    if miss:
        o = o + 10.0 * np.sign(o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, np.inf, np.float32)
    act = np.ones(n, bool)
    if masked:
        maxt[::2] = rng.uniform(0.2, 3.0, n)[::2]
        act[::3] = False
    return tuple(jnp.asarray(x) for x in (v0, e1, e2, o, d, maxt, act))


# (triangles, rays, kwargs of _scene, kernel block / chunk)
CASES = {
    "ragged": (37, 300, {}, {}),  # M % chunk != 0, N % block != 0
    "aligned": (16, 256, {}, {}),
    "masked": (37, 300, {"masked": True}, {}),
    "all_miss": (37, 300, {"miss": True}, {}),
    "one_triangle": (1, 5, {}, {}),
    "small_tiles": (5, 70, {"masked": True}, {"block": 32, "chunk": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_hit_interpret_matches_soup(case):
    m, n, kw, tiles = CASES[case]
    args = _scene(m, n, seed=m * 1000 + n, **kw)
    t_r, p_r, _u, _v = (np.asarray(x) for x in intersect_soup(*args))
    t_k, p_k = (np.asarray(x) for x in
                closest_hit_triton(*args, interpret=True, **tiles))
    np.testing.assert_array_equal(p_k, p_r)
    hit = p_r >= 0
    # t within 1e-5 relative; Möller–Trumbore's t loses digits as 1/|cos| of
    # the incidence angle, so grazing hits get that much more room
    v0, e1, e2, _o, d = (np.asarray(x, np.float64) for x in args[:5])
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    cos = np.abs(np.sum(d[hit] * n[p_r[hit]], -1))
    rtol = 1e-5 * np.maximum(1.0, 0.05 / cos)
    assert (np.abs(t_k[hit] - t_r[hit]) <= rtol * np.abs(t_r[hit])).all()
    assert np.isinf(t_k[~hit]).all()
    if kw.get("miss"):
        assert not hit.any()
    else:
        assert hit.any()
    if kw.get("masked"):
        assert (p_k[~np.asarray(args[6])] == -1).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_any_hit_interpret_matches_soup(case):
    m, n, kw, tiles = CASES[case]
    args = _scene(m, n, seed=m * 1000 + n + 1, **kw)
    occ_r = np.asarray(ray_test_soup(*args))
    occ_k = np.asarray(ray_test_triton(*args, interpret=True, **tiles))
    np.testing.assert_array_equal(occ_k, occ_r)
    assert occ_k.dtype == np.bool_
    if kw.get("miss"):
        assert not occ_k.any()


@pytest.mark.parametrize("query", ["closest", "any"])
def test_cpu_takes_jnp_path(query):
    """Lowered for the CPU, the dispatch holds no kernel and returns the jnp
    sweep's answer bit for bit."""
    args = _scene(37, 300, seed=3, masked=True)
    fn, ref = ((closest_hit, lambda *a: intersect_soup(*a)[:2])
               if query == "closest" else (ray_test, ray_test_soup))
    hlo = jax.jit(fn).lower(*args).as_text()
    assert "custom_call" not in hlo and "triton" not in hlo
    for got, want in zip(jax.tree.leaves(fn(*args)),
                         jax.tree.leaves(ref(*args))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("query,name", [("closest", "mitr_closest_hit"),
                                        ("any", "mitr_any_hit")])
def test_cuda_lowering_takes_kernel(query, name):
    """Lowered for CUDA (no card needed to lower), the same call is the
    Triton-route kernel."""
    fn = closest_hit if query == "closest" else ray_test
    args = _scene(36, 1024, seed=4)
    hlo = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in hlo and name in hlo


def _subjaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in _subjaxprs(value):
                out.extend(_dot_precisions(sub))
    return out


def _highest(p):
    hi = jax.lax.Precision.HIGHEST
    return p is not None and all(q == hi for q in (
        p if isinstance(p, tuple) else (p, p)))


def _graft_pass():
    sys.path.insert(0, ROOT)
    import __graft_entry__

    return __graft_entry__.entry()


def _regen_pass():
    import mitransient_tpu as mitr
    from mitransient_tpu.film.transient_film import film_init_any
    from mitransient_tpu.render import _regen_render
    from mitransient_tpu.sensors.perspective import build_camera

    d = mitr.cornell_box()
    d["sensor"]["film"].update(width=8, height=8, temporal_bins=16)
    scene = mitr.load_dict(d)
    cfg = scene.sensors[0]
    film = film_init_any(cfg.film, 3)

    def fn(sd, seed):
        return _regen_render(sd, build_camera(cfg), film, seed,
                             film_cfg=cfg.film, icfg=scene.integrator,
                             spp_total=8, lanes_per_pixel=4)

    return fn, (scene.data, jnp.uint32(0))


def _spectral_pass():
    import mitransient_tpu as mitr
    from mitransient_tpu.film.transient_film import film_init_any
    from mitransient_tpu.render import _perspective_pass
    from mitransient_tpu.sensors.perspective import build_camera

    old = mitr.variant().name
    mitr.set_variant("spectral")
    try:
        d = mitr.cornell_box()
        d["sensor"]["film"].update(width=8, height=8, temporal_bins=16)
        scene = mitr.load_dict(d)
    finally:
        mitr.set_variant(old)
    cfg = scene.sensors[0]
    film = film_init_any(cfg.film, scene.variant.color_channels)

    def fn(sd, seed):
        return _perspective_pass(
            sd, build_camera(cfg), film, seed, jnp.uint32(0),
            jnp.float32(0.5), film_cfg=cfg.film, icfg=scene.integrator,
            width=8, height=8, spp_chunk=2, spectral=True)

    return fn, (scene.data, jnp.uint32(0))


@pytest.mark.parametrize("make", [_graft_pass, _regen_pass, _spectral_pass],
                         ids=["graft_entry", "regen", "spectral"])
def test_every_dot_general_is_highest(make):
    """Float32 products of small matrices (rotations, the spectral -> sRGB
    conversion) must not drop to TF32 on the card: every dot_general of a
    cbox pass asks for HIGHEST precision."""
    fn, args = make()
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert all(_highest(p) for p in precisions), precisions
    if make is _spectral_pass:  # the sRGB conversion is a matrix product
        assert precisions


def _cache_dir_in_subprocess(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, mitransient_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_environment(tmp_path):
    assert _cache_dir_in_subprocess(str(tmp_path)) == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    import mitransient_tpu as mitr

    got = _cache_dir_in_subprocess(None)
    assert got == mitr.COMPILE_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke_dir(tmp_path, alone):
    if not alone:
        return ROOT
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    return str(tmp_path)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """Without a GPU, or without the repository beside it, the smoke script
    exits non-zero and prints no ok line."""
    cwd = _smoke_dir(tmp_path, alone)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
