"""Shared workload definitions for the golden-regression lock.

Used by both scripts/make_goldens.py (writes tests/goldens/*.npz) and
tests/test_golden.py (asserts today's output still matches), so the two can
never drift apart.  Every config is tiny enough to render on CPU in seconds
but exercises a distinct estimator/variant path.  The goldens lock the
*absolute radiometry* proven correct by tests/test_oracle.py: any estimator,
binning, RNG-stream or variant drift fails the lock.
"""
import numpy as np

import mitransient_tpu as mitr


def _small_cbox(w, h, bins, max_depth):
    d = mitr.cornell_box()
    d["sensor"]["film"]["width"] = w
    d["sensor"]["film"]["height"] = h
    d["sensor"]["film"]["temporal_bins"] = bins
    d["integrator"]["max_depth"] = max_depth
    return d


def _render(desc, variant="rgb", **kw):
    old = mitr.variant().name
    mitr.set_variant(variant)
    try:
        scene = mitr.load_dict(desc)
        s, t = mitr.render(scene, **kw)
        return {"steady": np.asarray(s), "transient": np.asarray(t)}
    finally:
        mitr.set_variant(old)


def cbox_rgb():
    """Canonical cbox, regen fast path (utils.py:78-220 geometry)."""
    return _render(_small_cbox(16, 16, 120, 6), spp=8, seed=0)


def cbox_rgb_multipass():
    """Same scene through the multi-pass accumulator (common.py:51-85)."""
    return _render(_small_cbox(16, 16, 120, 6), spp=8, seed=0,
                   regenerate=False)


def cbox_polarized():
    """mono_polarized 4-Stokes channel packing
    (transient_image_block.py:90-99)."""
    return _render(_small_cbox(8, 8, 80, 4), variant="mono_polarized",
                   spp=4, seed=0)


def cbox_spectral():
    """Hero-wavelength spectral variant with sRGB film conversion."""
    return _render(_small_cbox(8, 8, 80, 4), variant="spectral",
                   spp=4, seed=0)


def volumetric():
    """transient_prbvolpath with homogeneous HG fog in the small box
    (cbox_volumetric.xml pattern)."""
    d = _small_cbox(8, 8, 120, 5)
    d["integrator"] = {"type": "transient_prbvolpath", "max_depth": 5,
                       "rr_depth": 99}
    d["small-box"]["bsdf"] = {"type": "null"}
    d["small-box"]["medium"] = {
        "type": "homogeneous",
        "sigma_t": 2.0,
        "albedo": {"type": "rgb", "value": [0.9, 0.9, 0.9]},
        "phase": {"type": "hg", "g": 0.1},
    }
    return _render(d, spp=8, seed=0)


def nlos_single():
    """NLOS Z capture, laser + hidden-geometry sampling
    (transientnlospath.py semantics)."""
    return _render(mitr.utils.nlos_scene(sx=4, sy=4, bins=200), spp=16,
                   seed=0)


def phasor():
    """Frequency-domain film (phasor_image_block.py DFT accumulation)."""
    d = mitr.cornell_box()
    d["integrator"]["max_depth"] = 4
    d["sensor"]["film"] = {
        "type": "phasor_hdr_film",
        "width": 8,
        "height": 8,
        "temporal_bins": 400,
        "bin_width_opl": 0.02,
        "start_opl": 3.5,
        "wl_mean": 0.5,
        "wl_sigma": 0.5,
    }
    return _render(d, variant="mono", spp=8, seed=0)


def gradients():
    """PRB backward parameter-table gradients (prb.py two-sweep replay)."""
    d = _small_cbox(8, 8, 100, 4)
    d["sensor"]["film"]["start_opl"] = 0.0
    d["sensor"]["film"]["bin_width_opl"] = 0.2
    d["integrator"]["rr_depth"] = 99
    scene = mitr.load_dict(d)
    ones_s = np.ones((8, 8, 3), np.float32)
    ones_t = np.ones((8, 8, 100, 3), np.float32)
    g = mitr.render_backward(scene, (ones_s, ones_t), spp=8, seed=0)
    t = g["__tables__"]
    return {
        "bsdf_reflectance": np.asarray(t.bsdf_reflectance),
        "emitter_radiance": np.asarray(t.emitter_radiance),
    }


WORKLOADS = {
    "cbox_rgb": cbox_rgb,
    "cbox_rgb_multipass": cbox_rgb_multipass,
    "cbox_polarized": cbox_polarized,
    "cbox_spectral": cbox_spectral,
    "volumetric": volumetric,
    "nlos_single": nlos_single,
    "phasor": phasor,
    "gradients": gradients,
}
