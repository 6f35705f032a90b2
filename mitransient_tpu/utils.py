"""User-facing utilities (parity with /root/reference/mitransient/utils.py)."""
from __future__ import annotations

speed_of_light = 299792458.0
"""Speed of light in meters/second (reference utils.py:5)."""


def cornell_box():
    """Transient Cornell box scene dict — the canonical benchmark workload
    (reference utils.py:78-220): 256x256, 300 bins, start_opl 3.5,
    bin_width_opl 0.02, transient_path max_depth 8."""
    return {
        "type": "scene",
        "integrator": {
            "type": "transient_path",
            "camera_unwarp": False,
            "max_depth": 8,
            "temporal_filter": "box",
            "gaussian_stddev": 2.0,
        },
        "sensor": {
            "type": "perspective",
            "fov_axis": "smaller",
            "near_clip": 0.001,
            "far_clip": 100.0,
            "focus_distance": 1000,
            "fov": 39.3077,
            "to_world": {
                "look_at": {
                    "origin": [0, 0, 3.90],
                    "target": [0, 0, 0],
                    "up": [0, 1, 0],
                }
            },
            "sampler": {"type": "independent", "sample_count": 256},
            "film": {
                "type": "transient_hdr_film",
                "width": 256,
                "height": 256,
                "rfilter": {"type": "box"},
                "temporal_bins": 300,
                "start_opl": 3.5,
                "bin_width_opl": 0.02,
            },
        },
        "white": {
            "type": "diffuse",
            "reflectance": {"type": "rgb", "value": [0.885809, 0.698859, 0.666422]},
        },
        "green": {
            "type": "diffuse",
            "reflectance": {"type": "rgb", "value": [0.105421, 0.37798, 0.076425]},
        },
        "red": {
            "type": "diffuse",
            "reflectance": {"type": "rgb", "value": [0.570068, 0.0430135, 0.0443706]},
        },
        "light": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 0.99, 0.01],
                "rotate": {"axis": [1, 0, 0], "angle": 90},
                "scale": [0.23, 0.19, 0.19],
            },
            "bsdf": {"type": "ref", "id": "white"},
            "emitter": {
                "type": "area",
                "radiance": {"type": "rgb", "value": [18.387, 13.9873, 6.75357]},
            },
        },
        "floor": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, -1.0, 0.0],
                "rotate": {"axis": [1, 0, 0], "angle": -90},
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
        "ceiling": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 1.0, 0.0],
                "rotate": {"axis": [1, 0, 0], "angle": 90},
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
        "back": {
            "type": "rectangle",
            "to_world": {"translate": [0.0, 0.0, -1.0]},
            "bsdf": {"type": "ref", "id": "white"},
        },
        "green-wall": {
            "type": "rectangle",
            "to_world": {
                "translate": [1.0, 0.0, 0.0],
                "rotate": {"axis": [0, 1, 0], "angle": -90},
            },
            "bsdf": {"type": "ref", "id": "green"},
        },
        "red-wall": {
            "type": "rectangle",
            "to_world": {
                "translate": [-1.0, 0.0, 0.0],
                "rotate": {"axis": [0, 1, 0], "angle": 90},
            },
            "bsdf": {"type": "ref", "id": "red"},
        },
        "small-box": {
            "type": "cube",
            "to_world": {
                "translate": [0.335, -0.7, 0.38],
                "rotate": {"axis": [0, 1, 0], "angle": -17},
                "scale": 0.3,
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
        "large-box": {
            "type": "cube",
            "to_world": {
                "translate": [-0.33, -0.4, -0.28],
                "rotate": {"axis": [0, 1, 0], "angle": 18.25},
                "scale": [0.3, 0.61, 0.3],
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
    }


def nlos_scene(sx=4, sy=4, laser_sampling=True, hg_sampling=True,
               account=False, bins=300, spp=64):
    """Canonical NLOS scene dict (the nlos-z-simple.xml pattern): a relay
    wall ``[-1,1]^2`` at z=0 carrying an ``sx`` x ``sy`` nlos_capture_meter,
    a projector laser at ``(-0.5, 0, 0.25)`` and a hidden unit rectangle
    at z=1 facing the wall; ``bins`` bins of 0.02 OPL,
    ``transient_nlos_path`` at max_depth 4."""
    return {
        "type": "scene",
        "integrator": {
            "type": "transient_nlos_path",
            "max_depth": 4,
            "filter_depth": -1,
            "nlos_laser_sampling": laser_sampling,
            "nlos_hidden_geometry_sampling": hg_sampling,
            "nlos_hidden_geometry_sampling_do_rroulette": False,
            "nlos_hidden_geometry_sampling_includes_relay_wall": False,
            "account_first_and_last_bounces": account,
            "temporal_filter": "box",
        },
        # hidden target: unit rectangle at z=1 facing the wall (normal -z)
        "hidden-target": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 0.0, 1.0],
                "rotate": {"axis": [0, 1, 0], "angle": 180},
                "scale": 0.5,
            },
            "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        },
        "laser": {
            "type": "projector",
            "to_world": {"translate": [-0.5, 0.0, 0.25]},
            "irradiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]},
            "fov": 0.2,
        },
        # relay wall: [-1,1]^2 rectangle at z=0, normal +z
        "relay_wall": {
            "type": "rectangle",
            "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
            "nlos_sensor": {
                "type": "nlos_capture_meter",
                "sampler": {"type": "independent", "sample_count": spp,
                            "seed": 0},
                "sensor_origin": [-0.5, 0.0, 0.25],
                "film": {
                    "type": "transient_hdr_film",
                    "width": sx,
                    "height": sy,
                    "temporal_bins": bins,
                    "bin_width_opl": 0.02,
                    "start_opl": 0.0,
                },
            },
        },
    }
