"""The port stands alone: ``os1_tpu_torch`` imports neither JAX nor the JAX
package, at import time or while it runs frames in the shipped mode
(pipelined, cooperative mapping, loop closing, the BoW database and the
relocalizer), imports what ``System.warmup()`` imports and loads its
libraries, runs the host helpers of ``native.py``, or trains a vocabulary and reads the photographs, its Osmap
persistence needs neither protobuf, PyYAML nor
OpenCV, its shell (``io/``, ``viz/``, ``run_slam.py``) imports OpenCV only
inside functions, its distributed back end (``parallel/``) imports neither,
and its System builds every mode (the worker threads included), runs
``distributed=True`` only over a mesh (the reference's RuntimeError without
one) and runs on the CPU only when asked to. No JAX is needed to run this
file."""
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
import os1_tpu_torch.geometry.sim3
import os1_tpu_torch.io.osmap_io
import os1_tpu_torch.optim.pose_graph
import os1_tpu_torch.optim.sim3_opt
import os1_tpu_torch.parallel
import os1_tpu_torch.parallel.backend
import os1_tpu_torch.parallel.dist_ba
import os1_tpu_torch.parallel.dist_database
import os1_tpu_torch.parallel.dist_pose_graph
import os1_tpu_torch.parallel.mesh
import os1_tpu_torch.pipeline.local_mapping
import os1_tpu_torch.pipeline.loop_closing
import os1_tpu_torch.pipeline.relocalization
import os1_tpu_torch.pipeline.workers
import os1_tpu_torch.run_slam
import os1_tpu_torch.io.config
import os1_tpu_torch.io.datasets
import os1_tpu_torch.io.video
import os1_tpu_torch.viz.viewer
import os1_tpu_torch.solvers.pnp
import os1_tpu_torch.solvers.sim3_solver
import os1_tpu_torch.utils.transfer
import os1_tpu_torch.vocab.database
import os1_tpu_torch.vocab.dbow2
import os1_tpu_torch.vocab.native
import os1_tpu_torch.vocab.tree
import os1_tpu_torch.vocab.train
import os1_tpu_torch.io.realimg
import os1_tpu_torch.native
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
s = System(cfg, enable_mapping=True, pipelined=True, coop_mapping=True, device="cpu")
assert s.coop.loop_steps is not None
# System.warmup()'s imports, made inside it, and its library loader.
import os1_tpu_torch.ops.cuda_build
import os1_tpu_torch.solvers.initializer
assert os1_tpu_torch.ops.cuda_build.load_libraries(cuda=False)
assert callable(s.warmup)
states = [s.track_monocular(img)[0] for img in
          synthetic.render_sequence(synthetic.default_scene(seed=3), poses[:6], K, H, W)]
for img in np.zeros((3, H, W), np.float32):  # black frames: lost, then relocalization
    states.append(s.track_monocular(img)[0])
s.flush()
assert states[0] == TrackingState.NOT_INITIALIZED, states
assert s.db.vocab.n_words > 0
# Vocabulary training and the photographs, at a toy size.
from os1_tpu_torch.io import realimg
from os1_tpu_torch.vocab import train
assert len(realimg.photo_room_scene()) == 4
descs, docs = train.training_descriptors(n_images=2, n_features=64, device="cpu")
assert train.build_vocabulary(descs, 3, 2, device="cpu").n_words > 0
assert train.build_vocabulary_native(descs, 3, 2, doc_ids=docs).n_words > 0
# The host helpers.
from os1_tpu_torch import native
assert native.rgb_to_gray(np.zeros((4, 5, 3), np.uint8)).shape == (4, 5)
ring = native.NativeRingBuffer(2, (3,))
assert ring.push(np.arange(3, dtype=np.uint8)) and ring.pop() is not None
assert native.point_distinctive_desc(np.zeros((2, 4, 8), np.uint32), np.ones((2, 4), bool)).tolist() == [0, 0]
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


def _imports(tree, module_level=False):
    """(node, module name) of every absolute import; with ``module_level``,
    only those that run when the module is imported (outside functions)."""
    todo = [tree]
    while todo:
        node = todo.pop()
        if module_level and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from ((node, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module or ""
        todo.extend(ast.iter_child_nodes(node))


def test_no_module_imports_jax_or_the_jax_package():
    """Nothing in the port imports JAX or the JAX package; nothing under
    ``io/`` or ``viz/`` and not ``run_slam.py`` imports protobuf, PyYAML or
    OpenCV when it is imported (the card's machine has none of them), and
    OpenCV is imported nowhere else."""
    offenders = []
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        banned = [(("jax", "jaxlib", "os1_tpu"), False)]
        rel = os.path.relpath(path, PKG)
        if rel.startswith(("io" + os.sep, "viz" + os.sep)) or rel == "run_slam.py":
            banned.append((("google", "yaml", "cv2"), True))
        else:
            banned.append((("cv2",), False))
        for tops, module_level in banned:
            for _, n in _imports(tree, module_level):
                if n.split(".")[0] in tops:
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
    dict(enable_mapping=True, enable_loop_closing=True, coop_mapping=True, distributed=True),
    dict(enable_mapping=True, enable_loop_closing=False, coop_mapping=True, distributed=True),
    dict(enable_mapping=False, enable_loop_closing=False, distributed=True),
    dict(enable_mapping=True, enable_loop_closing=True, pipelined=True, async_mapping=True,
         distributed=True),
    dict(enable_mapping=True, enable_loop_closing=True, distributed=True),
])
def test_system_refuses_options_outside_the_slice(kw):
    """distributed=True needs a mesh: with one device and no mesh it raises
    the reference's RuntimeError; with a CPU mesh each mode builds and routes
    local BA, global BA and the essential graph through its backend;
    distributed=False refuses a mesh and None on the CPU stays single-device."""
    import numpy as np
    import torch

    from os1_tpu_torch.parallel import Mesh, MeshBABackend
    from os1_tpu_torch.pipeline import System

    cfg = _tiny_config()
    with pytest.raises(RuntimeError, match="requires more than one device"):
        System(cfg, device="cpu", **kw)
    mesh = Mesh(np.full(8, torch.device("cpu"), dtype=object), ("points",))
    s = System(cfg, device="cpu", mesh=mesh, **kw)
    try:
        assert isinstance(s.mesh_backend, MeshBABackend) and s.mesh_backend.mesh is mesh
        assert s.mapper.mesh_backend is s.mesh_backend is s.loop_closer.mesh_backend
        assert s.mapper._ba_fns()[1] == s.mesh_backend.begin
    finally:
        s.shutdown()
    off = dict(kw, distributed=False)
    with pytest.raises(ValueError, match="distributed=False"):
        System(cfg, device="cpu", mesh=mesh, **off)
    for d in (None, False):
        s = System(cfg, device="cpu", **dict(kw, distributed=d))
        try:
            assert s.mesh_backend is None and s.mapper.mesh_backend is None
        finally:
            s.shutdown()


@pytest.mark.parametrize("kw", [
    dict(pipelined=True, coop_mapping=True),
    dict(pipelined=True),
    dict(coop_mapping=True),
    dict(enable_mapping=False, pipelined=True, coop_mapping=True),
    dict(enable_mapping=True, enable_loop_closing=True, pipelined=True, async_mapping=True),
    dict(enable_mapping=True, enable_loop_closing=False, pipelined=True, async_mapping=True),
    dict(enable_mapping=False, enable_loop_closing=False, async_mapping=True),
])
def test_system_accepts_the_ported_modes(kw):
    """Every ported mode, loop closing on unless turned off; with the worker
    threads on, the LocalMapping thread (and the LoopClosing thread with loop
    closing) run until shutdown."""
    from os1_tpu_torch.pipeline import System

    s = System(_tiny_config(), device="cpu", **kw)
    try:
        assert s.tracker.pipelined == kw.get("pipelined", False)
        assert (s.coop is not None) == kw.get("coop_mapping", False)
        assert (s.mapping_worker is not None) == kw.get("async_mapping", False)
        assert s.tracker.relocalizer is s.relocalizer and s.relocalizer.db is s.db
        assert s.mapper.on_cull_keyframe == s.db.erase
        assert s.loop_closer.db is s.db and s.loop_closer.store is s.store
        assert s.tracker.loop_closing_active() is False
        assert s.tracker.lock is s.mapper.lock is s.loop_closer.lock is s.lock
        if s.coop is not None:
            assert s.coop.loop_steps is not None
        assert s.mapper.queued_fn == (s.mapping_worker.queued if s.mapping_worker
                                      is not None else None)
        if s.mapping_worker is not None:
            assert s.mapping_worker._thread.is_alive()
            assert (s.loop_worker is not None) == kw["enable_loop_closing"]
            assert s.loop_closer.mapping_worker is s.mapping_worker
    finally:
        s.shutdown()
    if s.mapping_worker is not None:
        assert not s.mapping_worker._thread.is_alive()
        assert s.loop_worker is None or not s.loop_worker._thread.is_alive()


def test_persistence_is_refused(tmp_path):
    """Persistence runs on a tiny CPU system: an empty map saved and loaded,
    and a merge of it refused (rolled back: it holds no keyframe to align)."""
    from os1_tpu_torch.pipeline import System, TrackingState

    cfg = _tiny_config()
    s = System(cfg, enable_mapping=False, enable_loop_closing=False, device="cpu")
    base = str(tmp_path / "tiny")
    header = s.save_map(base)
    assert (header["nKeyframes"], header["nMappoints"], header["nFeatures"]) == (0, 0, 0)
    assert all(os.path.exists(base + ext)
               for ext in (".yaml", ".mappoints", ".keyframes", ".features"))
    assert s.load_map(base + ".yaml")["cameraMatrices"] == [
        {"fx": 100.0, "fy": 100.0, "cx": 40.0, "cy": 30.0}]
    assert s.state == TrackingState.LOST and s.store.n_keyframes() == 0
    assert s.merge_session(base) is False
    assert s.store.n_keyframes() == 0 and s.store.n_points() == 0


def test_system_without_a_device_needs_a_card(monkeypatch):
    """device=None means the card: without one, System raises instead of
    running on the CPU; device="cpu" is the only way onto the CPU."""
    import torch

    from os1_tpu_torch.pipeline import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(cfg, enable_loop_closing=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(cfg, pipelined=True, coop_mapping=True, enable_loop_closing=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(cfg, pipelined=True, coop_mapping=True)
    assert System(cfg, enable_loop_closing=False, device="cpu").device.type == "cpu"
