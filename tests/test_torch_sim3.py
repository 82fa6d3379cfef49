"""Port parity of the loop-closing solvers: Sim3 algebra
(os1_tpu_torch.geometry.sim3), Horn's Sim3 RANSAC
(os1_tpu_torch.solvers.sim3_solver), Sim3 LM (os1_tpu_torch.optim.sim3_opt)
and the essential-graph LM (os1_tpu_torch.optim.pose_graph), against the JAX
package on the cases of tests/test_loop_solvers.py (the same numpy inputs from
a seed). Tolerances:

- ``exp`` and ``log`` within atol 1e-5 of the JAX package, round trips within
  1e-5, on random tangents and on both Taylor branches (sigma and theta near
  and at 0); forward-mode Jacobians of both finite at every branch and within
  atol 1e-4 of ``jax.jacfwd``.
- ``solve_sim3`` with the JAX draw handed over (a sampler that replays
  ``lax.top_k`` of ``jax.random.gumbel`` over the valid pairs): success and
  the inlier mask exact, R, t and s within atol 1e-4.
- ``optimize_sim3``: the inlier mask exact, S12 within atol 1e-4; its
  written-out Jacobians against forward-mode autodiff of its residuals,
  relative 1e-4.
- ``optimize_pose_graph`` on the drift-loop graph: within atol 1e-3 of the
  JAX poses; the fixed node unchanged bit for bit.
"""
import numpy as np
import pytest
import torch

from os1_tpu_torch.geometry import sim3 as tsim3

INTR = np.array([400.0, 400.0, 320.0, 240.0], np.float32)


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the float results do not depend on the host's
    core count, and parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """Sampler replaying solve_sim3's draw from a JAX key."""

    def __init__(self, key):
        self.key = key

    def __call__(self, valid, iters, k):
        import jax
        import jax.numpy as jnp

        v = jnp.asarray(valid.cpu().numpy())
        g = jnp.where(v[None, :], jax.random.gumbel(self.key, (iters, v.shape[0])), -jnp.inf)
        return torch.from_numpy(np.asarray(jax.lax.top_k(g, k)[1]).astype(np.int64))


# ------------------------------------------------------------ algebra --

TANGENTS = {
    "random": np.random.default_rng(3).normal(size=(6, 7)).astype(np.float32) * 0.4,
    "zero": np.zeros((1, 7), np.float32),
    "sigma_small": np.array([[0.3, -0.2, 0.1, 0.2, -0.1, 0.3, 3e-6],
                             [0.3, -0.2, 0.1, 0.2, -0.1, 0.3, 0.0]], np.float32),
    "theta_small": np.array([[0.3, -0.2, 0.1, 2e-6, 0.0, -1e-6, 0.2],
                             [0.3, -0.2, 0.1, 0.0, 0.0, 0.0, -0.2]], np.float32),
    "both_small": np.array([[0.3, -0.2, 0.1, 2e-6, 0.0, 1e-6, 4e-6]], np.float32),
}


@pytest.mark.parametrize("case", list(TANGENTS))
def test_exp_log_match_jax(jax_mods, case):
    jax, jnp = jax_mods
    from os1_tpu.geometry import sim3 as jsim3

    xi = TANGENTS[case]
    S_j = np.asarray(jsim3.exp_batch(jnp.asarray(xi)))
    S_t = tsim3.exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(S_t, S_j, atol=1e-5)
    log_j = np.asarray(jsim3.log_batch(jnp.asarray(S_j)))
    log_t = tsim3.log(torch.from_numpy(S_j.copy())).numpy()
    np.testing.assert_allclose(log_t, log_j, atol=1e-5)
    np.testing.assert_allclose(log_t, xi, atol=1e-5)  # round trip
    inv = tsim3.inverse(torch.from_numpy(S_t)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jsim3.inverse(jnp.asarray(S_j))), atol=1e-5)
    np.testing.assert_allclose(inv @ S_t, np.broadcast_to(np.eye(4), S_t.shape), atol=1e-5)
    np.testing.assert_allclose(tsim3.to_se3(torch.from_numpy(S_t)).numpy(),
                               np.asarray(jsim3.to_se3(jnp.asarray(S_j))), atol=1e-5)


@pytest.mark.parametrize("case", list(TANGENTS))
def test_jacobians_through_the_branches_are_finite(jax_mods, case):
    """Forward-mode Jacobians of exp at the tangent and of log at its image,
    against jax.jacfwd: no untaken branch leaks a NaN."""
    jax, jnp = jax_mods
    from os1_tpu.geometry import sim3 as jsim3

    from os1_tpu_torch.utils.numerics import jacfwd_rows

    xi = TANGENTS[case]
    J_t = jacfwd_rows(tsim3.exp, torch.from_numpy(xi)).numpy()  # [B, 4, 4, 7]
    S = tsim3.exp(torch.from_numpy(xi))
    # log's Jacobian along a left increment: d/dd log(exp(d) S) at d = 0.
    L_t = jacfwd_rows(lambda d: tsim3.log(tsim3.exp(d) @ S), torch.zeros_like(
        torch.from_numpy(xi))).numpy()
    assert np.isfinite(J_t).all() and np.isfinite(L_t).all()
    for b in range(len(xi)):
        J_j = np.asarray(jax.jacfwd(jsim3.exp)(jnp.asarray(xi[b])))
        L_j = np.asarray(jax.jacfwd(lambda d: jsim3.log(jsim3.exp(d) @ jnp.asarray(
            S[b].numpy())))(jnp.zeros(7)))
        np.testing.assert_allclose(J_t[b], J_j, atol=1e-4)
        np.testing.assert_allclose(L_t[b], L_j, atol=1e-4)


# ------------------------------------------------------- Sim3 RANSAC --

def _sim3_case(name):
    from test_loop_solvers import make_sim3_case

    rng = np.random.default_rng(0)
    if name == "outliers":
        return make_sim3_case(rng, n=150, outliers=50), 1, False
    if name == "fix_scale":
        return make_sim3_case(rng, scale=1.0), 2, True
    return make_sim3_case(rng), 0, False


@pytest.mark.parametrize("case", ["exact", "outliers", "fix_scale"])
def test_solve_sim3_matches_jax(jax_mods, case):
    jax, jnp = jax_mods
    from os1_tpu.geometry import sim3 as jsim3
    from os1_tpu.solvers.sim3_solver import solve_sim3 as jsolve

    from os1_tpu_torch.solvers.sim3_solver import solve_sim3

    (x1, x2, uv1, uv2, S12), seed, fix = _sim3_case(case)
    n = len(x1)
    key = jax.random.PRNGKey(seed)
    r = jsolve(jnp.asarray(x1), jnp.asarray(x2), jnp.ones(n, bool), jnp.asarray(uv1),
               jnp.asarray(uv2), jnp.ones(n), jnp.ones(n), jnp.asarray(INTR), key,
               fix_scale=fix)
    t = solve_sim3(torch.from_numpy(x1), torch.from_numpy(x2), torch.ones(n, dtype=torch.bool),
                   torch.from_numpy(uv1), torch.from_numpy(uv2), torch.ones(n), torch.ones(n),
                   torch.from_numpy(INTR), JaxDraws(key), fix_scale=fix)
    assert bool(t.success) == bool(r.success)
    assert np.array_equal(t.inliers.numpy(), np.asarray(r.inliers))
    assert int(t.n_inliers) == int(r.n_inliers)
    for a, b in zip(tsim3.to_Rts(t.S12), jsim3.to_Rts(r.S12)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    if case != "fix_scale":
        assert np.abs(t.S12.numpy() - S12).max() < (2e-2 if case == "exact" else 5e-2)
    else:
        assert abs(float(tsim3.to_Rts(t.S12)[2]) - 1.0) < 1e-4


# ----------------------------------------------------------- Sim3 LM --

@pytest.mark.parametrize("case", ["noisy_init", "outlier_pairs"])
def test_optimize_sim3_matches_jax(jax_mods, case):
    jax, jnp = jax_mods
    from os1_tpu.geometry import sim3 as jsim3
    from os1_tpu.optim.sim3_opt import optimize_sim3 as jopt
    from test_loop_solvers import make_sim3_case

    from os1_tpu_torch.optim.sim3_opt import optimize_sim3

    rng = np.random.default_rng(0)
    if case == "noisy_init":
        x1, x2, uv1, uv2, S12 = make_sim3_case(rng)
        noise = np.array([0.03, -0.02, 0.01, 0.01, -0.02, 0.015, 0.05], np.float32)
        S0 = (np.asarray(jsim3.exp(jnp.asarray(noise))) @ S12).astype(np.float32)
    else:
        x1, x2, uv1, uv2, S12 = make_sim3_case(rng, n=120)
        x2 = x2.copy()
        x2[:15] += 2.0
        S0 = S12
    n = len(x1)
    r = jopt(jnp.asarray(S0), jnp.asarray(x1), jnp.asarray(x2), jnp.ones(n, bool),
             jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(n), jnp.ones(n), jnp.asarray(INTR))
    t = optimize_sim3(torch.from_numpy(S0), torch.from_numpy(x1), torch.from_numpy(x2),
                      torch.ones(n, dtype=torch.bool), torch.from_numpy(uv1),
                      torch.from_numpy(uv2), torch.ones(n), torch.ones(n), torch.from_numpy(INTR))
    assert np.array_equal(t.inliers.numpy(), np.asarray(r.inliers))
    assert int(t.n_inliers) == int(r.n_inliers)
    np.testing.assert_allclose(t.S12.numpy(), np.asarray(r.S12), atol=1e-4)
    if case == "noisy_init":
        np.testing.assert_allclose(t.S12.numpy(), S12, atol=3e-3)
        assert int(t.n_inliers) == n
    else:
        assert not t.inliers[:15].any() and t.inliers[15:].all()


# ------------------------------------------------------ essential graph --

def _drift_loop(jnp):
    from os1_tpu.geometry import se3 as jse3
    from os1_tpu.geometry import sim3 as jsim3

    K = 20
    gt = [np.eye(4, dtype=np.float32)]
    step = np.asarray(jse3.exp(jnp.asarray([0.5, 0.0, 0.0, 0.0, -2 * np.pi / K, 0.0],
                                           jnp.float32)))
    for _ in range(1, K):
        gt.append((step @ gt[-1]).astype(np.float32))
    gt = np.stack(gt)
    bias = np.asarray(jsim3.exp(jnp.asarray([0.01, 0.005, 0.0, 0.0, 0.008, 0.0, 0.01],
                                            jnp.float32)))
    drift = [gt[0].copy()]
    for i in range(1, K):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        drift.append((bias @ rel @ drift[-1]).astype(np.float32))
    drift = np.stack(drift)
    ei = list(range(K - 1)) + [0]
    ej = list(range(1, K)) + [K - 1]
    eS = [drift[i + 1] @ np.linalg.inv(drift[i]) for i in range(K - 1)]
    eS.append(gt[K - 1] @ np.linalg.inv(gt[0]))
    return (drift, np.arange(K) == 0, np.array(ei, np.int32), np.array(ej, np.int32),
            np.stack(eS).astype(np.float32), 25, gt)


def _consistent_chain(jnp):
    K = 5
    S = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for i in range(1, K):
        S[i, 0, 3] = i * 1.0
    ei = np.arange(K - 1, dtype=np.int32)
    ej = ei + 1
    eS = np.stack([S[j] @ np.linalg.inv(S[i]) for i, j in zip(ei, ej)]).astype(np.float32)
    return S, np.arange(K) == 0, ei, ej, eS, 5, None


@pytest.mark.parametrize("case", ["loop_drift", "fixed_node"])
def test_pose_graph_matches_jax(jax_mods, case):
    jax, jnp = jax_mods
    from os1_tpu.optim.pose_graph import optimize_pose_graph as jopt

    from os1_tpu_torch.optim.pose_graph import optimize_pose_graph

    S, fixed, ei, ej, eS, iters, gt = (_drift_loop if case == "loop_drift"
                                       else _consistent_chain)(jnp)
    K = len(S)
    r = np.asarray(jopt(jnp.asarray(S), jnp.ones(K, bool), jnp.asarray(fixed), jnp.asarray(ei),
                        jnp.asarray(ej), jnp.asarray(eS), jnp.ones(len(ei), bool), iters=iters))
    t = optimize_pose_graph(torch.from_numpy(S), torch.ones(K, dtype=torch.bool),
                            torch.from_numpy(fixed), torch.from_numpy(ei), torch.from_numpy(ej),
                            torch.from_numpy(eS), iters=iters).numpy()
    np.testing.assert_allclose(t, r, atol=1e-3)
    assert np.array_equal(t[0], S[0])  # the fixed node, bit for bit
    if case == "loop_drift":  # the JAX test's own bounds
        T_opt = tsim3.to_se3(torch.from_numpy(t)).numpy()
        end_before = np.abs(S[K - 1] - gt[K - 1]).max()
        assert np.abs(T_opt[K - 1] - gt[K - 1]).max() < 0.25 * end_before
    else:
        np.testing.assert_allclose(t, S, atol=1e-3)


def test_sim3_lm_jacobians_match_forward_mode_autodiff():
    """The port's written-out Sim3 LM Jacobians against forward-mode autodiff
    of the residuals (the reference's jax.jacfwd), relative 1e-4."""
    from test_loop_solvers import make_sim3_case

    from os1_tpu_torch.optim.sim3_opt import _linearize, _residuals
    from os1_tpu_torch.utils.numerics import jacfwd_rows

    x1, x2, uv1, uv2, S12 = make_sim3_case(np.random.default_rng(0), outliers=10)
    noise = torch.tensor([0.03, -0.02, 0.01, 0.01, -0.02, 0.015, 0.05])
    S0 = tsim3.exp(noise) @ torch.from_numpy(S12)
    args = [torch.from_numpy(a) for a in (x1, x2, uv1, uv2)] + [torch.from_numpy(INTR)]
    r, J = (t.numpy() for t in _linearize(S0, *args))
    J_ad = jacfwd_rows(lambda xi: _residuals(xi, S0, *args), torch.zeros(7)).numpy()
    assert J.shape == J_ad.shape == (2 * len(x1), 2, 7)
    np.testing.assert_array_equal(r, _residuals(torch.zeros(7), S0, *args).numpy())
    np.testing.assert_allclose(J, J_ad, rtol=1e-4, atol=1e-4 * np.abs(J_ad).max())
