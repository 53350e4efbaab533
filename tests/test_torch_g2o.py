"""Port parity: g2o file I/O and the solve_g2o CLI (the counterpart of
tests/test_g2o_eval.py's g2o tests), against cslam_tpu on the CPU.

- the port's quaternion conversions against cslam_tpu.ops.se3 on 64
  seeded rotations and the identity / near-pi cases (QUAT_TOL);
- a graph written by either package reads back in the other: the same
  keys and loop flags, poses within POSE_TOL (both parse the same
  9-digit text into f32) and sqrt-informations within SQRT_INFO_TOL
  (the same f64 Cholesky of the same parsed numbers);
- `solve_g2o.main([..., "--cpu"])` against the reference's CLI on its
  test graph: the same JSON keys, poses and factors, and final costs
  within COST_RTOL;
- DecentralizedPGO's g2o dump (write_current_estimates_callback) writes
  a file that the reference's read_g2o reads.
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cslam_tpu.backend import g2o as jg2o
from cslam_tpu.backend.factor_graph import BetweenFactor as JBF
from cslam_tpu.backend.factor_graph import FactorGraph as JFG
from cslam_tpu.backend.factor_graph import diag_sqrt_info
from cslam_tpu.ops import se3 as jse3
from cslam_tpu.tools import solve_g2o as jsolve
from cslam_tpu_torch.backend import g2o as tg2o
from cslam_tpu_torch.backend.factor_graph import BetweenFactor as TBF
from cslam_tpu_torch.backend.factor_graph import FactorGraph as TFG
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.ops import se3 as tse3
from cslam_tpu_torch.tools import solve_g2o as tsolve

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

QUAT_TOL = 1e-5
POSE_TOL = 1e-6
SQRT_INFO_TOL = 1e-5
COST_RTOL = 1e-4
PACKAGES = {"jax": (JFG, JBF, jg2o), "port": (TFG, TBF, tg2o)}


def test_quat_roundtrip_matches_reference():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 3)) * 1.5).astype(np.float32)
    near_pi = np.array([[0, 0, 0], [np.pi - 1e-4, 0, 0],
                        [0, np.pi - 1e-4, 0]], np.float32)
    for ws in (w, near_pi):
        R = np.asarray(jse3.so3_exp(jnp.asarray(ws)))
        q_port = tse3.rot_to_quat(torch.from_numpy(R.copy())).numpy()
        q_ref = np.asarray(jse3.rot_to_quat(jnp.asarray(R)))
        np.testing.assert_allclose(q_port, q_ref, atol=QUAT_TOL)
        R_port = tse3.quat_to_rot(torch.from_numpy(q_port)).numpy()
        np.testing.assert_allclose(R_port, R, atol=QUAT_TOL)
        np.testing.assert_allclose(
            R_port, np.asarray(jse3.quat_to_rot(jnp.asarray(q_ref))),
            atol=QUAT_TOL)


def _graph(FG, BF, seed=1):
    """test_g2o_eval.test_g2o_roundtrip's chain of 10 poses with one
    loop closure, and a full (non-diagonal) information on one edge."""
    rng = np.random.default_rng(seed)
    fg = FG()
    sq = diag_sqrt_info([0.02] * 3 + [0.1] * 3)
    A = rng.standard_normal((6, 6)).astype(np.float32) * 0.3
    full = (np.triu(A) + np.diag(np.full(6, 5.0, np.float32)))
    R_prev, t_prev = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    fg.add_node((0, 0), R_prev, t_prev)
    for k in range(9):
        xi = rng.standard_normal(6).astype(np.float32) * 0.3
        dR, dt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi)))
        fg.add_between(BF((0, k), (0, k + 1), dR, dt,
                          full if k == 4 else sq))
        R_new = R_prev @ dR
        t_new = R_prev @ dt + t_prev
        fg.add_node((0, k + 1), R_new, t_new)
        R_prev, t_prev = R_new, t_new
    fg.add_between(BF((0, 0), (0, 5), np.eye(3, dtype=np.float32),
                      np.ones(3, dtype=np.float32), sq, is_loop=True))
    return fg


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_g2o_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                       reader):
    FG, BF, g_w = PACKAGES[writer]
    g_r = PACKAGES[reader][2]
    fg = _graph(FG, BF)
    path = str(tmp_path / "graph.g2o")
    g_w.write_g2o(fg, path)
    ours, theirs = g_r.read_g2o(path), g_w.read_g2o(path)
    assert ours.keys == theirs.keys == fg.keys
    assert ours.prior_key == theirs.prior_key
    for k in range(ours.num_nodes):
        np.testing.assert_allclose(ours.R[k], theirs.R[k], atol=POSE_TOL)
        np.testing.assert_allclose(ours.t[k], theirs.t[k], atol=POSE_TOL)
    assert len(ours.factors) == len(theirs.factors) == len(fg.factors)
    for a, b in zip(ours.factors, theirs.factors):
        assert (a.key_from, a.key_to, a.is_loop) == \
            (b.key_from, b.key_to, b.is_loop)
        np.testing.assert_allclose(a.R, b.R, atol=POSE_TOL)
        np.testing.assert_allclose(a.t, b.t, atol=POSE_TOL)
        np.testing.assert_allclose(a.sqrt_info, b.sqrt_info,
                                   atol=SQRT_INFO_TOL)
    assert sum(f.is_loop for f in ours.factors) == 1
    # the full information survives the file: Gamma^T Gamma as written
    info = fg.factors[4].sqrt_info.T @ fg.factors[4].sqrt_info
    back = ours.factors[4].sqrt_info.T @ ours.factors[4].sqrt_info
    np.testing.assert_allclose(back, info, rtol=1e-4, atol=1e-3)


def _cli_graph(path, loops):
    """tests/test_g2o_eval.py::test_solve_g2o_cli's noisy 20-pose chain,
    written by the reference; with `loops`, also three loop closures
    whose measurements disagree with the chain, so that the optimum's
    cost is not zero."""
    rng = np.random.default_rng(5)
    fg = JFG()
    sq = diag_sqrt_info([0.02] * 3 + [0.1] * 3)
    Rk, tk = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    fg.add_node((0, 0), Rk, tk)
    truth = [(Rk, tk)]
    for k in range(19):
        xi = rng.standard_normal(6).astype(np.float32) * 0.2
        dR, dt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi)))
        fg.add_between(JBF((0, k), (0, k + 1), dR, dt, sq))
        tk = Rk @ dt + tk
        Rk = Rk @ dR
        truth.append((Rk, tk))
        nR, nt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(
            rng.standard_normal(6).astype(np.float32) * 0.05)))
        fg.add_node((0, k + 1), Rk @ nR, tk + nt)
    for i, j in ((0, 10), (5, 15), (8, 19)) if loops else ():
        (Ri, ti), (Rj, tj) = truth[i], truth[j]
        nR, nt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(
            rng.standard_normal(6).astype(np.float32) * 0.02)))
        fg.add_between(JBF((0, i), (0, j), Ri.T @ Rj @ nR,
                           Ri.T @ (tj - ti) + nt, sq, is_loop=True))
    fg.set_prior((0, 0))
    jg2o.write_g2o(fg, path)
    return fg


@pytest.mark.parametrize("loops", [False, True])
def test_solve_g2o_cli_matches_reference(tmp_path, capsys, loops):
    """Final costs within COST_RTOL, or, where both solves reach the
    exact optimum of the loop-free chain (cost zero), within f32
    rounding of the initial cost."""
    src = str(tmp_path / "in.g2o")
    fg = _cli_graph(src, loops)
    out = {}
    for name, cli in (("jax", jsolve), ("port", tsolve)):
        dst = str(tmp_path / f"out_{name}.g2o")
        assert cli.main([src, "-o", dst, "--cpu"]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
        out[name]["graph"] = jg2o.read_g2o(dst)
    port, ref = out["port"], out["jax"]
    assert set(port) == set(ref)
    assert port["platform"] == ref["platform"] == "cpu"
    for key in ("poses", "factors", "loop_closures", "rejected_loops"):
        assert port[key] == ref[key], key
    assert port["poses"] == fg.num_nodes
    assert port["final_cost"] < port["initial_cost"]
    assert port["initial_cost"] == pytest.approx(ref["initial_cost"],
                                                 rel=COST_RTOL)
    f32_floor = float(np.finfo(np.float32).eps) * ref["initial_cost"]
    assert port["final_cost"] == pytest.approx(ref["final_cost"],
                                               rel=COST_RTOL, abs=f32_floor)
    if loops:
        assert ref["final_cost"] > 1e3 * f32_floor
    gp, gr = port["graph"], ref["graph"]
    assert gp.keys == gr.keys
    np.testing.assert_allclose(np.stack(gp.t), np.stack(gr.t), atol=1e-3)


def test_g2o_dump_callback_reads_in_reference(tmp_path):
    """write_current_estimates_callback (the reference's on-demand g2o
    dump) on both packages' back-ends after the same odometry, with the
    odometry as the current estimates: the port's file holds the
    estimates and the local factors between them, and the reference's
    read_g2o reads it into the graph it reads from its own dump."""
    from cslam_tpu.backend.decentralized_pgo import DecentralizedPGO as JDP
    from cslam_tpu.comm import bus as jbus
    from cslam_tpu.comm import messages as jmsgs
    from cslam_tpu_torch.backend.decentralized_pgo import \
        DecentralizedPGO as TDP
    from cslam_tpu_torch.comm import bus as tbus

    rng = np.random.default_rng(3)
    poses = []
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for k in range(5):
        dR, dt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(
            rng.standard_normal(6).astype(np.float32) * 0.2)))
        t, R = R @ dt + t, R @ dR
        poses.append((R, t))
    graphs = {}
    for name, DP, bus, m, kw in (("jax", JDP, jbus, jmsgs, {}),
                                 ("port", TDP, tbus, tmsgs,
                                  {"device": "cpu"})):
        router = bus.InProcessRouter()
        be = DP({"robot_id": 0, "max_nb_robots": 1},
                bus.InProcessBus(router, 0), bus.ManualClock(), **kw)
        try:
            for k, pose in enumerate(poses):
                be.odometry_callback(m.KeyframeOdom(id=k, pose=pose))
            be.current_pose_estimates = dict(be.odometry_pose_estimates)
            path = str(tmp_path / f"dump_{name}.g2o")
            be.bus.publish("cslam/print_current_estimates", path)
            router.spin_until_idle()
            graphs[name] = jg2o.read_g2o(path)
        finally:
            if hasattr(be, "close"):
                be.close()
    port, ref = graphs["port"], graphs["jax"]
    assert port.keys == ref.keys == [(0, k) for k in range(5)]
    assert port.num_factors == ref.num_factors == 4
    for k, (R, t) in enumerate(poses):
        np.testing.assert_allclose(port.t[k], t, atol=POSE_TOL)
        np.testing.assert_allclose(port.R[k], ref.R[k], atol=POSE_TOL)
        np.testing.assert_allclose(port.t[k], ref.t[k], atol=POSE_TOL)
    for a, b in zip(port.factors, ref.factors):
        assert (a.key_from, a.key_to) == (b.key_from, b.key_to)
        np.testing.assert_allclose(a.t, b.t, atol=POSE_TOL)
        np.testing.assert_allclose(a.sqrt_info, b.sqrt_info,
                                   atol=SQRT_INFO_TOL)
