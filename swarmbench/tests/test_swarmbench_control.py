"""The comparison that decides `correct` fails what it should, on the
CPU at tiny sizes: the reference's TF32 control in the program's place,
and the timed path broken underneath a run (an answer altered where it
is produced, in each layer the cells judge; a solve that returns its
state unchanged; an ICP that returns the identity)."""

import numpy as np
import pytest

from swarmbench import compare
from swarmbench.harness import Cell, Run
from swarmbench.run import run_cell

CONTROL_NUMBERS = {"sim5r.revisit": ["topk_err", "pgo_cost_err",
                                     "pgo_grad_ratio"],
                   "lidar2r.revisit": ["voxel_err", "reg_rmse_err",
                                       "pgo_cost_err", "pgo_grad_ratio"]}


def _window(root, workload, seed, seconds=3.0):
    import torch
    cell = Cell(root, workload)
    run = Run(cell, seed, torch.device("cpu"))
    try:
        run.warm_up()
        run.window(seconds)
        run.latency_drain()
    finally:
        run.close()
    return cell, run


@pytest.mark.parametrize("workload", sorted(CONTROL_NUMBERS))
def test_control_fails(root, workload):
    """Sound numbers sit under their limits; the control, judged the same
    way, is not correct, and reads each of the numbers it moves at three
    times the sound reading or more (the limits themselves come from the
    chip at the cells' own size, PERF.md)."""
    cell, run = _window(root, workload, 41)
    limits = cell.config["limits"]
    sound = compare.numbers(run)
    ok, rows = compare.judge(sound, limits)
    assert ok, rows
    ctl = compare.numbers(run, control=True)
    assert not compare.judge(ctl, limits)[0]
    for name in CONTROL_NUMBERS[workload]:
        assert ctl[name] >= 3 * sound[name], (name, ctl[name], sound[name])


def _second_best(monkeypatch):
    from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase

    def second(self, query):
        items, sims = self.search(query, 2)
        if not items:
            return None, None
        return items[-1], sims[-1]
    monkeypatch.setattr(DescriptorDatabase, "search_best", second)


def _duplicate_selection(monkeypatch):
    from cslam_tpu_torch.sparsification.acm import \
        AlgebraicConnectivityMaximization as ACM
    select = ACM.select_candidates

    def altered(self, *a, **k):
        out = select(self, *a, **k)
        return out + out[:1]
    monkeypatch.setattr(ACM, "select_candidates", altered)


def _moved_pose(monkeypatch):
    from cslam_tpu_torch.backend import pgo
    optimize = pgo.optimize

    def altered(fg, *a, **k):
        res = optimize(fg, *a, **k)
        fg.t[-1] = fg.t[-1] + np.float32(1.0)
        return res
    monkeypatch.setattr(pgo, "optimize", altered)


def _unchanged_solve(monkeypatch):
    """Every solve returns its initial state, with the cost it reports
    being that state's."""
    import torch
    from cslam_tpu_torch.backend import pgo

    def unchanged(g, cfg=pgo.PGOConfig()):
        ones = torch.ones_like(g.edge_mask)
        cost = pgo.graph_cost(g, g.R, g.t, ones)
        return pgo.PGOResult(R=g.R, t=g.t, cost=cost, initial_cost=cost,
                             gnc_iters=0, weights=ones)
    monkeypatch.setattr(pgo, "gnc_optimize", unchanged)


def _shared_shifted(monkeypatch):
    from cslam_tpu_torch.backend.factor_graph import FactorGraph
    estimates = FactorGraph.estimates_for_robot

    def altered(self, robot_id):
        return {k: (R, t + np.float32(0.01))
                for k, (R, t) in estimates(self, robot_id).items()}
    monkeypatch.setattr(FactorGraph, "estimates_for_robot", altered)


def _voxels_shifted(monkeypatch):
    from cslam_tpu_torch.ops import registration
    voxel = registration.voxel_downsample

    def altered(points, mask, size):
        c, keep = voxel(points, mask, size)
        return c + 0.05, keep
    monkeypatch.setattr(registration, "voxel_downsample", altered)


def _fit_misreported(monkeypatch):
    from cslam_tpu_torch.ops import registration
    icp = registration.gnc_icp

    def altered(*a, **k):
        res = icp(*a, **k)
        return res._replace(rmse=res.rmse * 1.1)
    monkeypatch.setattr(registration, "gnc_icp", altered)


def _identity_icp(monkeypatch):
    """Every ICP returns the identity, with that transform's own fit."""
    import torch
    from cslam_tpu_torch.ops import registration
    icp = registration.gnc_icp

    def identity(src, src_mask, dst, dst_mask, R_init, t_init, **k):
        k.update(gnc_steps=0, max_iters=0)
        return icp(src, src_mask, dst, dst_mask,
                   torch.eye(3, dtype=src.dtype, device=src.device),
                   torch.zeros(3, dtype=src.dtype, device=src.device), **k)
    monkeypatch.setattr(registration, "gnc_icp", identity)


FAULTS = [("sim5r.revisit", _second_best, "topk_err"),
          ("sim5r.revisit", _duplicate_selection, "selection_faults"),
          ("sim5r.revisit", _moved_pose, "pgo_cost_err"),
          ("sim5r.revisit", _unchanged_solve, "pgo_grad_ratio"),
          ("lidar2r.revisit", _unchanged_solve, "pgo_grad_ratio"),
          ("sim5r.revisit", _shared_shifted, "estimate_mismatch"),
          ("lidar2r.revisit", _voxels_shifted, "voxel_err"),
          ("lidar2r.revisit", _fit_misreported, "reg_rmse_err")]


def _fault_id(workload, fault):
    """The fault's name, with the cell's front-end where two cells
    plant it."""
    name = fault.__name__.strip("_")
    cells = {w for w, f, _ in FAULTS if f is fault}
    return name if len(cells) == 1 else f"{name}_{workload.split('.')[0]}"


@pytest.mark.parametrize("workload,fault,number", FAULTS,
                         ids=[_fault_id(w, f) for w, f, _ in FAULTS])
def test_fault_fails(root, monkeypatch, workload, fault, number):
    fault(monkeypatch)
    result, rows, _ = run_cell(root, workload, 43, 3.0, device="cpu")
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"], rows


def test_identity_icp_fails_on_card(card, monkeypatch, tmp_path):
    """At the cell's own size an ICP that returns the identity, with its
    own fit, is not correct: the true revisits it accepts read their
    true offset against reg_truth_err_m (the tiny clouds cannot tell an
    identity from a sound registration)."""
    from .conftest import tiny_root
    _identity_icp(monkeypatch)
    root = tiny_root(tmp_path, tiny=False)
    result, rows, _ = run_cell(root, "lidar2r.revisit", 2**31 + 401, 20.0)
    assert not result["correct"]
    check = result["checks"]["reg_truth_err_m"]
    assert check["value"] > check["limit"], rows
