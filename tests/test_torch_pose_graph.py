"""The pose solve as a CUDA graph (``optim/pose_opt.py``): on CUDA tensors
``optimize_pose`` replays the graph captured for its input signature, on CPU
tensors it runs the eager loop.

On the CPU: the same results as ``_optimize_pose_eager`` bit for bit and no
graph cached, a cache key that separates shapes, dtypes and schedules, and
no ``trk.pose_graph`` span. On the card (marked ``cuda``; skipped without an
NVIDIA GPU): the replay bit-equal to the eager loop on the same CUDA tensors
(the same kernels in the same order on the same stream, so tolerance 0) at
the fused step's N = 1,024 and 2,048 under both schedules and at
relocalization's [5, N] batch; results that a later replay leaves as they
were; one capture per key, then replays; a capture while another thread
launches on the default stream; six threads solving on one key at once. No
JAX is needed, so the file runs on the card's machine: ``python -m pytest
--noconftest -m cuda tests/test_torch_pose_graph.py``.
"""
import threading

import numpy as np
import pytest
import torch

from os1_tpu_torch.geometry import se3
from os1_tpu_torch.optim import pose_opt
from os1_tpu_torch.utils.profiling import StageTimer

INTR = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
SCHEDULES = [(3, 4, False), (4, 10, True)]


def _problem(n, batch=(), seed=0, device="cpu"):
    """A pose problem of ``n`` observations with noise and gross outliers:
    (Tcw0, points, uv, sigma2, valid, intr); ``batch`` leading lanes of
    Tcw0, points and valid share uv and sigma2, as relocalization's do."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(3, 9, (n, 1))], 1)
    xi = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01])
    T_true = se3.exp(torch.from_numpy(xi)).numpy()
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * INTR[:2] + INTR[2:] + rng.normal(0, 0.5, (n, 2))
    uv[: n // 10] += rng.uniform(30, 60, (n // 10, 2))
    s2 = 1.2 ** (2 * rng.integers(0, 8, n))
    lanes = int(np.prod(batch))
    T0 = np.stack([se3.exp(torch.from_numpy(xi * (0.8 + 0.05 * k))).numpy()
                   for k in range(max(lanes, 1))]).reshape(batch + (4, 4))
    pts = np.broadcast_to(X, batch + (n, 3)) + rng.normal(0, 1e-3, batch + (n, 3))
    valid = rng.random(batch + (n,)) < 0.9

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return (t(T0), t(pts), t(uv), t(s2), t(valid, torch.bool), t(INTR))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------- #
# CPU: the eager loop, no graph
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("batch", [(), (5,)], ids=["single", "batch5"])
def test_cpu_is_the_eager_loop(sched, batch):
    before = dict(pose_opt._GRAPHS)
    args = _problem(256, batch)
    r, i, ar = sched
    got = pose_opt.optimize_pose(*args, rounds=r, iters_per_round=i, accept_reject=ar)
    assert _equal(got, pose_opt._optimize_pose_eager(*args, *sched))
    assert int(got.n_inliers.min()) > 150
    assert pose_opt._GRAPHS == before  # empty here; on the card, the card tests' keys
    assert not any(k[0].type == "cpu" for k in pose_opt._GRAPHS)


@pytest.mark.parametrize("change", [
    "n", "batch", "uv_rows", "points_dtype", "pose_dtype", "valid_dtype",
    "rounds", "iters", "accept_reject"])
def test_key_separates_signatures(change):
    args, sched = list(_problem(64)), (3, 4, False)
    key = pose_opt._graph_key(args, sched)
    # Other values, the same signature: the same graph.
    assert pose_opt._graph_key(list(_problem(64, seed=1)), sched) == key
    other, other_sched = list(args), sched
    if change == "n":
        other = list(_problem(128))
    elif change == "batch":
        other = list(_problem(64, (5,)))
    elif change == "uv_rows":
        other[2] = other[2][None].expand(5, 64, 2)
    elif change == "points_dtype":
        other[1] = other[1].double()
    elif change == "pose_dtype":
        other[0] = other[0].double()
    elif change == "valid_dtype":
        other[4] = other[4].to(torch.uint8)
    else:
        k = ("rounds", "iters", "accept_reject").index(change)
        other_sched = tuple((4, 10, True)[j] if j == k else sched[j] for j in range(3))
    assert pose_opt._graph_key(other, other_sched) != key


def test_cpu_opens_no_graph_span():
    timer = StageTimer()
    pose_opt.optimize_pose(*_problem(128), rounds=3, iters_per_round=4, accept_reject=False,
                           timer=timer)
    assert "trk.pose_graph" not in timer.counts and not timer.totals


# --------------------------------------------------------------------------- #
# The card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs exist only on the card")
    return torch.device("cuda")


def _solve(args, sched, timer=None):
    r, i, ar = sched
    return pose_opt.optimize_pose(*args, rounds=r, iters_per_round=i, accept_reject=ar,
                                  timer=timer)


@pytest.mark.cuda
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("n,batch", [(1024, ()), (2048, ()), (1024, (5,)), (2048, (5,))])
def test_card_graph_equals_eager(card, sched, n, batch):
    args = _problem(n, batch, seed=n, device=card)
    timer = StageTimer()
    first = _solve(args, sched, timer)  # captures at the first call of a new key
    again = _solve(args, sched, timer)
    eager = pose_opt._optimize_pose_eager(*args, *sched)
    torch.cuda.synchronize()
    assert _equal(first, eager) and _equal(again, eager)
    assert int(eager.n_inliers.min()) > 0.7 * n
    assert timer.counts["trk.pose_graph"] == 2


@pytest.mark.cuda
def test_card_results_outlive_the_next_replay(card):
    sched = (3, 4, False)
    a, b = _problem(1024, seed=11, device=card), _problem(1024, seed=12, device=card)
    ra = _solve(a, sched)
    kept = [t.clone() for t in ra]
    rb = _solve(b, sched)  # the same key: the same graph, its outputs overwritten
    torch.cuda.synchronize()
    assert _equal(ra, kept)
    assert not torch.equal(ra.Tcw, rb.Tcw)
    assert _equal(rb, pose_opt._optimize_pose_eager(*b, *sched))


@pytest.mark.cuda
def test_card_one_capture_per_key(card, monkeypatch):
    captures, replays = [], []

    class Counted(pose_opt._PoseGraph):
        def __init__(self, args, sched):
            captures.append(sched)
            super().__init__(args, sched)

        def __call__(self, args):
            replays.append(1)
            return super().__call__(args)

    monkeypatch.setattr(pose_opt, "_PoseGraph", Counted)
    n = 1152  # a key no other test meets
    for seed in range(3):
        _solve(_problem(n, seed=seed, device=card), (3, 4, False))
    _solve(_problem(n, seed=3, device=card), (4, 10, True))
    assert captures == [(3, 4, False), (4, 10, True)] and len(replays) == 4
    keys = [k for k in pose_opt._GRAPHS if k[2][0] == (n, 3)]
    assert len(keys) == 2


@pytest.mark.cuda
def test_card_capture_beside_a_launching_thread(card):
    stop, errors, launched = threading.Event(), [], []

    def launch():
        try:
            x = torch.randn(256, 256, device=card)
            while not stop.is_set():
                x = torch.tanh(x @ x.T / 256.0)  # the default stream
                launched.append(1)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    worker = threading.Thread(target=launch)
    worker.start()
    try:
        while not launched:
            pass
        args = _problem(1280, seed=5, device=card)  # a key no other test meets
        got = _solve(args, (3, 4, False))
    finally:
        stop.set()
        worker.join(timeout=60)
    torch.cuda.synchronize()
    assert not errors and not worker.is_alive()
    assert _equal(got, pose_opt._optimize_pose_eager(*args, 3, 4, False))


@pytest.mark.cuda
def test_card_threads_share_one_graph(card):
    """Threads solving on one key at once: each gets its own inputs' result
    (copy-in, replay and clone-out of a call are not interleaved)."""
    import sys

    sched, n = (3, 4, False), 1024
    probs = [_problem(n, seed=100 + k, device=card) for k in range(8)]
    want = [pose_opt._optimize_pose_eager(*p, *sched) for p in probs]
    got, errors = {}, []

    def work(k):
        try:
            for rep in range(5):
                j = (k + rep) % len(probs)
                got[(k, rep)] = (j, _solve(probs[j], sched))
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(k,)) for k in range(6)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not errors and not any(w.is_alive() for w in workers) and len(got) == 30
    assert all(_equal(r, want[j]) for j, r in got.values())
