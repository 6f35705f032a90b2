"""Benchmark suite over the reference's canonical workloads (BASELINE.md).

Each entry renders a workload pinned by the reference corpus and reports
rays/sec plus wall time as one JSON line, same schema as bench.py.  Run on
one GPU from the repo root (one JAX process per card):

    python benchmarks/suite.py [name ...]

Names: cbox, cbox_mirror, phasor, volumetric, polarized_cbox, nlos_single,
nlos_polarized, nlos_confocal, nlos_zroom, staircase.  Default: all.
Workload parameters cite the reference configs (file:line in the
mitransient repository).  The first line names the device; without a GPU
the run fails.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from benchmarks.device import header  # noqa: E402


def _report(name, value, best, rays, spp, **extra):
    print(json.dumps({
        "metric": f"{name}_rays_per_sec",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": None,
        "detail": {"wall_s": best, "rays": rays, "spp": spp, **extra},
    }), flush=True)


def _ref_scene(rel):
    """Resolve a reference example scene; MITR_REF_ROOT overrides the
    default /root/reference checkout.  Raises a clear SkipBench when the
    tree is absent instead of a bare FileNotFoundError."""
    import os

    root = os.environ.get("MITR_REF_ROOT", "/root/reference")
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        raise RuntimeError(
            f"benchmark scene not found: {path} — set MITR_REF_ROOT to a "
            "mitransient reference checkout or skip this workload")
    return path


def _run(scene, spp, seed=0, **kw):
    import mitransient_tpu as mitr

    s, t, stats = mitr.render(scene, spp=spp, seed=seed, return_stats=True,
                              **kw)
    jax.block_until_ready((s, t))
    return stats


def bench(name, make_scene, spp, reps=3, **kw):
    scene = make_scene()
    stats = _run(scene, spp, seed=0, **kw)  # warm/compile
    best = None
    for rep in range(reps):
        t0 = time.perf_counter()
        stats = _run(scene, spp, seed=1 + rep, **kw)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    rays = float(stats["rays"])
    _report(name, rays / best, best, rays, spp)


def cbox(**over):
    import mitransient_tpu as mitr

    d = mitr.cornell_box()
    for k, v in over.items():
        d[k] = v
    return mitr.load_dict(d)


def make_cbox():
    # 256x256, 300 bins, max_depth 8 (utils.py:78-220)
    return cbox()


def make_cbox_mirror():
    # cbox with a conductor box (cbox_mirror.xml)
    import mitransient_tpu as mitr

    d = mitr.cornell_box()
    d["small-box"]["bsdf"] = {"type": "conductor"}
    return mitr.load_dict(d)


def make_phasor():
    # 200x200 mono, wl_mean 100, wl_sigma 100 (cbox_diffuse_freq.xml:2-43)
    import mitransient_tpu as mitr

    old = mitr.variant().name
    mitr.set_variant("mono")
    d = mitr.cornell_box()
    d["sensor"]["film"] = {
        "type": "phasor_hdr_film", "width": 200, "height": 200,
        "wl_mean": 100.0, "wl_sigma": 100.0, "temporal_bins": 4000,
        "start_opl": 3.5, "bin_width_opl": 0.002,
    }
    scene = mitr.load_dict(d)
    mitr.set_variant(old)
    return scene


def make_volumetric():
    # 128x128, 400 bins, HG medium (cbox_volumetric.xml:1-120 pattern)
    import mitransient_tpu as mitr

    d = mitr.cornell_box()
    d["sensor"]["film"]["width"] = 128
    d["sensor"]["film"]["height"] = 128
    d["sensor"]["film"]["temporal_bins"] = 400
    d["integrator"] = {"type": "transient_prbvolpath", "max_depth": 16}
    d["small-box"]["bsdf"] = {"type": "null"}
    d["small-box"]["medium"] = {
        "type": "homogeneous", "sigma_t": 2.0,
        "albedo": {"type": "rgb", "value": [0.9, 0.9, 0.9]},
        "phase": {"type": "hg", "g": 0.3},
    }
    return mitr.load_dict(d)


def make_polarized_cbox():
    # 256x256 mono_polarized, gold GGX box (cbox_polarized.xml:1-55)
    import mitransient_tpu as mitr

    old = mitr.variant().name
    mitr.set_variant("mono_polarized")
    d = mitr.cornell_box()
    d["sensor"]["film"]["temporal_bins"] = 400
    d["small-box"]["bsdf"] = {
        "type": "roughconductor", "material": "Au", "alpha": 0.3}
    scene = mitr.load_dict(d)
    mitr.set_variant(old)
    return scene


def _nlos(confocal: bool):
    # NLOS scene (utils.nlos_scene; nlos-z-simple.xml pattern):
    # 32x32 scan, 300 bins, laser + hidden-geometry sampling
    import mitransient_tpu as mitr

    fx = mitr.utils

    if confocal:
        d = fx.nlos_scene(sx=1, sy=1)
        d["relay_wall"]["nlos_sensor"]["original_film_width"] = 32
        d["relay_wall"]["nlos_sensor"]["original_film_height"] = 32
    else:
        d = fx.nlos_scene(sx=32, sy=32)
    scene = mitr.load_dict(d)
    mitr.nlos.focus_emitter_at_relay_wall_pixel([16.0, 16.0], scene)
    return scene


def make_nlos_single():
    return _nlos(False)


def make_nlos_polarized():
    # polarized NLOS (transient_nlos_polarization.ipynb pattern: gold GGX
    # hidden target, mono_polarized), 32x32 scan
    import mitransient_tpu as mitr

    fx = mitr.utils

    old = mitr.variant().name
    mitr.set_variant("mono_polarized")
    d = fx.nlos_scene(sx=32, sy=32)
    d["hidden-target"]["bsdf"] = {
        "type": "roughconductor", "material": "Au", "alpha": 0.1}
    scene = mitr.load_dict(d)
    mitr.nlos.focus_emitter_at_relay_wall_pixel([16.0, 16.0], scene)
    mitr.set_variant(old)
    return scene


def make_nlos_confocal():
    return _nlos(True)


def make_staircase():
    # 262k-tri staircase (diff-transient/staircase/scene.xml), reduced
    # film/depth so the benchmark completes in seconds
    import mitransient_tpu as mitr

    return mitr.load_file(
        _ref_scene("examples/diff-transient/staircase/scene.xml"),
        resx=256, resy=256, max_depth=6)


def make_nlos_zroom():
    # the reference's COMPLEX NLOS scene (nlos-z-room.xml: Z target inside
    # a room, perspective-sensor NLOS with a pre-aimed projector laser;
    # canonical capture runs spp 250k — benched at reduced spp, same
    # per-ray work)
    import mitransient_tpu as mitr

    return mitr.load_file(
        _ref_scene("examples/transient-nlos/nlos-z-room.xml"))


ALL = {
    "cbox": (make_cbox, 512),
    "cbox_mirror": (make_cbox_mirror, 256),
    "phasor": (make_phasor, 128),
    "volumetric": (make_volumetric, 64),
    "polarized_cbox": (make_polarized_cbox, 64),
    "nlos_single": (make_nlos_single, 2048),
    "nlos_polarized": (make_nlos_polarized, 1024),
    "nlos_confocal": (make_nlos_confocal, 512),
    "nlos_zroom": (make_nlos_zroom, 1024),
    "staircase": (make_staircase, 8),
}


def bench_confocal_scan(spp=2048, reps=2):
    """The real confocal workload: the FULL 32x32 virtual-grid scan.

    Uses the batched scan (`mitr.nlos.scan_confocal`) — every scan point
    rendered in one wavefront with per-lane focused-laser constants,
    instead of the reference-style per-point focus+render loop whose
    host-side NLOS prepare per point would dominate the timing."""
    import mitransient_tpu as mitr

    scene = make_nlos_confocal()

    def sweep(seed):
        s, t, st = mitr.nlos.scan_confocal(scene, spp=spp, seed=seed,
                                           return_stats=True)
        jax.block_until_ready((s, t))
        return float(st["rays"])

    sweep(0)  # warm/compile
    best = None
    for rep in range(reps):
        t0 = time.perf_counter()
        rays = sweep(1 + rep)
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, best_rays = dt, rays
    _report("nlos_confocal_scan", best_rays / best, best, best_rays, spp,
            scan_points=32 * 32)


def main():
    names = sys.argv[1:] or list(ALL)
    print(json.dumps({"device": header()}), flush=True)
    for name in names:
        if name == "nlos_confocal":
            try:
                bench_confocal_scan()
            except Exception as e:
                print(json.dumps({"metric": name, "error": str(e)[:200]}),
                      flush=True)
            continue
        make, spp = ALL[name]
        try:
            bench(name, make, spp)
        except Exception as e:  # keep the suite going
            print(json.dumps({"metric": name, "error": str(e)[:200]}),
                  flush=True)


if __name__ == "__main__":
    main()
