"""Generate plugin documentation (markdown) from the package sources.

JAX counterpart of the reference's Sphinx doc generator
(/root/reference/docs/generate_plugin_doc.py + docs/exts/pluginparameters.py):
the reference scrapes ``.. pluginparameters::`` blocks out of plugin
docstrings into rst; here each plugin's parameter table is declared below,
the prose comes from the implementing module's docstring, and the output is
plain markdown under ``docs/plugins/``.

Run: ``python docs/generate_plugin_docs.py``  (re-run after changing any
plugin parameter; tests/test_docs.py checks the output is in sync).
"""
from __future__ import annotations

import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (category, plugin name, implementing module, parameters)
# Parameter tuples: (name, type, default, description)
PLUGINS = [
    ("integrators", "transient_path", "mitransient_tpu.integrators.path", [
        ("max_depth", "int", "6", "Maximum path depth (bounces + 1)."),
        ("rr_depth", "int", "5", "Depth at which Russian roulette starts."),
        ("camera_unwarp", "bool", "false",
         "Subtract the camera->first-hit distance from every path's OPL "
         "(reference transientpath.py:133-138)."),
        ("discard_direct_light", "bool", "false",
         "Drop emitter-hit contributions (keep NEE only)."),
        ("temporal_filter", "str", "box",
         "'box' or 'gaussian' reconstruction along the time axis."),
        ("gaussian_stddev", "float", "0.5",
         "Stddev (in bins) of the gaussian temporal filter."),
    ]),
    ("integrators", "transient_nlos_path",
     "mitransient_tpu.integrators.nlos_path", [
        ("max_depth", "int", "6", "Maximum path depth."),
        ("capture_type", "str", "single",
         "'single', 'confocal' or 'exhaustive' scan pattern "
         "(reference CaptureType, transientnlospath.py:12-13)."),
        ("nlos_laser_sampling", "bool", "false",
         "Two-segment NEE through the laser-illuminated relay-wall point "
         "with area->solid-angle pdf conversion "
         "(transientnlospath.py:511-635)."),
        ("nlos_hidden_geometry_sampling", "bool", "false",
         "Sample directions toward area-weighted points on the hidden "
         "geometry (transientnlospath.py:385-430)."),
        ("nlos_hidden_geometry_sampling_do_rroulette", "bool", "false",
         "50/50 mix hidden-geometry and BSDF sampling."),
        ("nlos_hidden_geometry_sampling_includes_relay_wall", "bool",
         "true", "Count the relay wall as hidden geometry."),
        ("account_first_and_last_bounces", "bool", "true",
         "Include laser->wall and wall->sensor path segments in the OPL."),
        ("filter_depth", "int", "-1",
         "Only record paths of exactly this depth."),
        ("discard_direct_paths", "bool", "false",
         "Drop paths shorter than 3 bounces."),
    ]),
    ("integrators", "transient_prbvolpath",
     "mitransient_tpu.integrators.volpath", [
        ("max_depth", "int", "6", "Maximum path depth."),
        ("rr_depth", "int", "5", "Russian-roulette start depth."),
        ("temporal_filter", "str", "box", "Temporal reconstruction filter."),
    ]),
    ("films", "transient_hdr_film", "mitransient_tpu.film.transient_film", [
        ("width / height", "int", "256", "Steady film resolution."),
        ("temporal_bins", "int", "2048",
         "Number of histogram bins along the time axis "
         "(transient_hdr_film.py:114)."),
        ("bin_width_opl", "float", "0.003",
         "Optical path length covered by one bin."),
        ("start_opl", "float", "0",
         "OPL at which the first bin starts."),
    ]),
    ("films", "phasor_hdr_film", "mitransient_tpu.film.phasor_film", [
        ("wl_mean", "float", "—",
         "Central wavelength of the phasor-field Morlet band "
         "(phasor_hdr_film.py:107-139)."),
        ("wl_sigma", "float", "—", "Wavelet bandwidth."),
        ("temporal_bins", "int", "2048",
         "Virtual bin count defining the frequency grid."),
    ]),
    ("sensors", "nlos_capture_meter",
     "mitransient_tpu.integrators.nlos_path", [
        ("sensor_origin", "point", "—",
         "Focal point all capture rays originate from "
         "(nloscapturemeter.py:104)."),
        ("confocal", "bool", "false",
         "1x1 film scanned over original_film_width/height points."),
        ("original_film_width / height", "int", "—",
         "Virtual scan grid in confocal mode."),
    ]),
    ("emitters", "angulararea", "mitransient_tpu.scene.scene", [
        ("radiance", "spectrum", "1", "Emitted radiance."),
        ("beam_width", "float", "15",
         "Full-intensity cone angle in degrees (angulararea.py:74-82)."),
        ("cutoff_angle", "float", "20",
         "Angle beyond which emission is zero; linear falloff between."),
    ]),
    ("emitters", "projector", "mitransient_tpu.scene.scene", [
        ("irradiance", "spectrum", "1", "Emitted power profile."),
        ("fov", "float", "45", "Frustum opening angle in degrees."),
    ]),
    ("media", "homogeneous", "mitransient_tpu.integrators.volpath", [
        ("sigma_t", "float", "1", "Extinction coefficient."),
        ("albedo", "spectrum", "0.75", "Single-scattering albedo."),
        ("phase.g", "float", "0", "Henyey-Greenstein anisotropy."),
    ]),
    ("media", "heterogeneous", "mitransient_tpu.integrators.volpath", [
        ("scale", "float", "1", "Density-to-sigma_t scale."),
        ("density", "grid / gridvolume", "—",
         "3-D density grid: inline (Z, Y, X) array or a Mitsuba .vol file; "
         "``to_world`` maps the unit cube onto the medium."),
        ("albedo", "spectrum", "0.75", "Single-scattering albedo."),
        ("phase.g", "float", "0", "Henyey-Greenstein anisotropy."),
    ]),
    ("bsdfs", "diffuse", "mitransient_tpu.bsdf.api", [
        ("reflectance", "spectrum", "0.5", "Lambertian albedo."),
    ]),
    ("bsdfs", "conductor", "mitransient_tpu.bsdf.api", [
        ("material", "str", "none",
         "Named complex IOR (Au, Ag, Al, Cu); 'none' = ideal mirror."),
        ("eta / k", "spectrum", "—", "Explicit complex IOR."),
    ]),
    ("bsdfs", "roughconductor", "mitransient_tpu.bsdf.api", [
        ("material / eta / k", "—", "Au", "Complex IOR as above."),
        ("alpha", "float", "0.1", "Isotropic GGX roughness."),
        ("alpha_u / alpha_v", "float", "alpha",
         "Anisotropic GGX roughness along the tangent / bitangent."),
    ]),
    ("bsdfs", "dielectric", "mitransient_tpu.bsdf.api", [
        ("int_ior / ext_ior", "float", "1.5046 / 1.000277",
         "Relative index of refraction."),
    ]),
    ("bsdfs", "plastic / roughplastic", "mitransient_tpu.bsdf.api", [
        ("diffuse_reflectance", "spectrum", "0.5", "Substrate albedo."),
        ("alpha", "float", "0.1 (0.03 for plastic)",
         "GGX roughness of the dielectric coating."),
        ("int_ior / ext_ior", "float", "1.49 / 1.000277", "Coating IOR."),
    ]),
    ("bsdfs", "null", "mitransient_tpu.bsdf.api", [
        ("—", "—", "—", "Invisible pass-through (medium boundaries)."),
    ]),
]


def module_summary(modname: str) -> str:
    try:
        mod = importlib.import_module(modname)
        doc = (mod.__doc__ or "").strip()
        return doc
    except Exception as e:  # documentation must not hard-fail on imports
        return f"(module docstring unavailable: {e})"


def generate(out_dir: str | None = None) -> list[str]:
    out_dir = out_dir or os.path.join(ROOT, "docs", "plugins")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    by_cat: dict[str, list] = {}
    for cat, name, mod, params in PLUGINS:
        by_cat.setdefault(cat, []).append((name, mod, params))

    index = ["# Plugin reference\n",
             "Generated by `docs/generate_plugin_docs.py` — the JAX "
             "counterpart of the reference's plugin-doc pipeline.\n"]
    for cat, plugs in by_cat.items():
        cat_dir = os.path.join(out_dir, cat)
        os.makedirs(cat_dir, exist_ok=True)
        index.append(f"\n## {cat}\n")
        for name, mod, params in plugs:
            fname = name.split(" ")[0].replace("/", "_")
            index.append(f"- [{name}]({cat}/{fname}.md)")
            lines = [f"# {name}\n",
                     f"*module: `{mod}`*\n",
                     "| Parameter | Type | Default | Description |",
                     "|---|---|---|---|"]
            for pn, pt, pd, desc in params:
                lines.append(f"| `{pn}` | {pt} | {pd} | {desc} |")
            lines.append("\n## Notes (from the implementation)\n")
            lines.append("```\n" + module_summary(mod) + "\n```")
            path = os.path.join(cat_dir, f"{fname}.md")
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            written.append(path)
    with open(os.path.join(out_dir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    written.append(os.path.join(out_dir, "index.md"))
    return written


if __name__ == "__main__":
    for p in generate():
        print("wrote", os.path.relpath(p, ROOT))
