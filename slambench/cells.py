"""What a cell names, found by name: ``BENCHMARK.json`` at the root of the
checkout, the configurations under ``slambench/configs/`` and the
per-layer and end-to-end metrics under ``slambench/metrics/``; and the
program's system built from a configuration through the port's public
constructors.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    """The configuration ``slambench/configs/<name>.json``."""
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def n_features(cfg: dict) -> int:
    """The feature count the port runs: the settings reader's rule
    (``os1_tpu_torch/io/config.py``) rounds nFeatures up to 128."""
    n = int(cfg["ORBextractor.nFeatures"])
    return (n + 127) // 128 * 128


def camera(cfg: dict) -> dict:
    """The lens and image of a configuration, as the renderer and the
    reference take them."""
    out = {k: float(cfg[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy", "fps")}
    out.update({k: float(cfg.get(f"Camera.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")})
    out["width"], out["height"] = int(cfg["Camera.width"]), int(cfg["Camera.height"])
    return out


def orb(cfg: dict) -> dict:
    """The extractor settings of a configuration, as the reference takes them."""
    return dict(h=int(cfg["Camera.height"]), w=int(cfg["Camera.width"]), n_features=n_features(cfg),
                n_levels=int(cfg["ORBextractor.nLevels"]),
                scale=float(cfg["ORBextractor.scaleFactor"]),
                fast_hi=float(cfg["ORBextractor.iniThFAST"]),
                fast_lo=float(cfg["ORBextractor.minThFAST"]))


MODE = {"System.pipelined": True, "System.coop_mapping": True, "System.async_mapping": False,
        "System.loop_closing": True}  # the shipped mode


def build_system(cfg: dict, device):
    """The program's system for a configuration, on ``device``, in the mode
    its ``System.*`` keys state (by default the shipped mode: pipelined
    tracking, cooperative mapping, loop closing on)."""
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig, System
    from os1_tpu_torch.pipeline.config import TrackingThresholds

    cam, o, n = camera(cfg), orb(cfg), n_features(cfg)
    lens = [cam[k] for k in ("k1", "k2", "p1", "p2", "k3")]
    slam = SlamConfig(
        camera=Camera.make(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], dist=lens,
                           width=cam["width"], height=cam["height"]),
        orb=OrbConfig(height=o["h"], width=o["w"], n_features=n, n_levels=o["n_levels"],
                      scale_factor=o["scale"], fast_hi=o["fast_hi"], fast_lo=o["fast_lo"]),
        map=MapConfig(max_keyframes=int(cfg["Map.max_keyframes"]),
                      max_points=int(cfg["Map.max_points"]), n_features=n),
        th=TrackingThresholds(max_local_points=int(cfg["Tracking.max_local_points"])))
    mode = {k: bool(cfg.get(k, v)) for k, v in MODE.items()}
    return System(slam, device=device, pipelined=mode["System.pipelined"],
                  coop_mapping=mode["System.coop_mapping"],
                  async_mapping=mode["System.async_mapping"],
                  enable_loop_closing=mode["System.loop_closing"])


def load_metric(name: str):
    """The reader module ``slambench/metrics/<name>.py``: ``read(window)``
    gives the metric's value, or None where the run has nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries of BENCHMARK.json a run of ``cell`` reports: the
    end-to-end ones with ``--trace 0``, the per-layer ones with ``--trace 1``,
    each where its ``workloads`` key (if any) names the cell and, for a
    per-layer metric, where the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]]) and m["moves"] in moved]
