"""The port stands alone: ``os1_tpu_torch`` imports neither JAX nor the JAX
package, at import time or while it runs frames with mapping on, and its
System refuses the options outside the ported slice and runs on the CPU only
when asked to. No JAX is needed to run this file."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "os1_tpu_torch")

_RUN_ONE_FRAME = r"""
import sys
import numpy as np
import os1_tpu_torch
import os1_tpu_torch.ops.patches
import os1_tpu_torch.pipeline.local_mapping
from os1_tpu_torch.features.orb import OrbConfig
from os1_tpu_torch.geometry.camera import Camera
from os1_tpu_torch.io import synthetic
from os1_tpu_torch.map.store import MapConfig
from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState

H, W = 120, 160
K = np.array([[130.0, 0, 80.0], [0, 130.0, 60.0], [0, 0, 1.0]])
poses = synthetic.orbit_trajectory(8, advance=0.08)
cfg = SlamConfig(camera=Camera.make(130.0, 130.0, 80.0, 60.0, width=W, height=H),
                 orb=OrbConfig(height=H, width=W, n_features=256, n_levels=3),
                 map=MapConfig(max_keyframes=8, max_points=512, n_features=256))
s = System(cfg, enable_mapping=True, enable_loop_closing=False, pipelined=False, device="cpu")
states = [s.track_monocular(img)[0] for img in
          synthetic.render_sequence(synthetic.default_scene(seed=3), poses[:4], K, H, W)]
assert states[0] == TrackingState.NOT_INITIALIZED, states
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "os1_tpu.")) or m == "os1_tpu")
print("LEAKED", bad)
"""


def test_import_and_one_frame_leave_jax_out():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _RUN_ONE_FRAME], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


def _py_files():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "os1_tpu"):
                    offenders.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert not offenders, offenders


def _tiny_config():
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig

    return SlamConfig(camera=Camera.make(100.0, 100.0, 40.0, 30.0, width=80, height=60),
                      orb=OrbConfig(height=60, width=80, n_features=64, n_levels=2),
                      map=MapConfig(max_keyframes=4, max_points=64, n_features=64))


@pytest.mark.parametrize("kw", [
    dict(enable_mapping=True, enable_loop_closing=False, pipelined=True),
    dict(enable_mapping=False, enable_loop_closing=True),
    dict(enable_mapping=False, enable_loop_closing=False, pipelined=True),
    dict(enable_mapping=False, enable_loop_closing=False, coop_mapping=True),
    dict(enable_mapping=False, enable_loop_closing=False, async_mapping=True),
    dict(enable_mapping=False, enable_loop_closing=False, distributed=True),
])
def test_system_refuses_options_outside_the_slice(kw):
    from os1_tpu_torch.pipeline import System

    cfg = _tiny_config()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        System(cfg, device="cpu", **kw)


def test_persistence_is_refused():
    from os1_tpu_torch.pipeline import System

    cfg = _tiny_config()
    s = System(cfg, enable_mapping=False, enable_loop_closing=False, device="cpu")
    for call in (lambda: s.save_map("x"), lambda: s.load_map("x"), lambda: s.merge_session("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_system_without_a_device_needs_a_card(monkeypatch):
    """device=None means the card: without one, System raises instead of
    running on the CPU; device="cpu" is the only way onto the CPU."""
    import torch

    from os1_tpu_torch.pipeline import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(cfg, enable_loop_closing=False)
    assert System(cfg, enable_loop_closing=False, device="cpu").device.type == "cpu"
