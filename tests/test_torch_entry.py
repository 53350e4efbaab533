"""Port parity, entry points (cslam_tpu_torch.entry against the repo's
__graft_entry__.py), on the CPU.

- entry(): the flagship forward, CosPlace GeoLocalizationNet(64) on a
  (4, 224, 224, 3) input; with the reference entry()'s model.init
  weights converted, the port's forward gives the reference's output
  (bf16 convs: 2e-3 and cosine 0.9999, tests/test_torch_models.py's
  bound).
- dryrun_multichip(4) on 4 gloo ranks (all four stages) against the
  reference's elastic protocol stage, _dryrun_protocol_on_mesh, on 4
  virtual devices: the same optimizer in each of the three solves, the
  same count of consistent shared estimates, and the first solve handed
  the same graph (1e-6). That graph, solved to convergence by both
  packages' factor-sharded solves on 4 ranks / devices, gives the same
  GNC rounds and weights, costs within rtol 1e-3, and poses within
  1e-3. The protocol's own solves are not compared pose by pose: they
  stop early (4 LM steps, 15 CG steps, 2 GNC rounds, from a cost in the
  millions), where the order of the sums decides the endpoint, so the
  two packages, or the port on 1 and on 4 ranks, end centimetres apart.
"""

import multiprocessing

import jax
import numpy as np
import torch
from flax.traverse_util import flatten_dict

import __graft_entry__ as jentry
from cslam_tpu.parallel import make_swarm_mesh as jmake_mesh
from cslam_tpu_torch.entry import dryrun_multichip, entry
from cslam_tpu_torch.models import convert as tconvert
from cslam_tpu_torch.models import cosplace as tcp

# a setting at which the protocol's first graph converges (PCG, as the
# protocol's solver; its own stops after 4 LM and 15 CG steps)
CONVERGED = dict(lm_max_iters=30, cg_max_iters=100, linear_solver="pcg")

def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# one intra-op thread per rank: the suite runs several pytest workers
# side by side, and every rank of a mesh is a process
torch.set_num_threads(1)


def test_entry_is_the_flagship_forward():
    model, (images,) = entry(device="cpu")
    assert isinstance(model, tcp.GeoLocalizationNet)
    assert tuple(images.shape) == (4, 224, 224, 3)
    forward, (variables, jimages) = jentry.entry()
    ref = np.asarray(jax.jit(forward)(variables, jimages))
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(jax.device_get(variables), sep="/").items()}
    tcp.load_flat_weights(model, tconvert.cosplace_state_dict(flat))
    with torch.no_grad():
        out = model(images).numpy()
    assert out.shape == ref.shape == (4, 64)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)
    assert np.min(np.sum(out * ref, axis=-1)) >= 0.9999


def test_dryrun_protocol_matches_reference(monkeypatch):
    import cslam_tpu.node as jnode
    from cslam_tpu.backend import factor_graph as jfg
    from cslam_tpu.backend import pgo as jpgo
    from cslam_tpu.parallel import distributed_pgo as jdist
    from cslam_tpu_torch.backend import factor_graph as tfg
    from cslam_tpu_torch.backend import pgo as tpgo
    from cslam_tpu_torch.parallel import distributed_pgo as tdist
    from cslam_tpu_torch.parallel import make_swarm_mesh

    made, graphs = [], {"ref": [], "port": []}
    for mod, key in ((jdist, "ref"), (tdist, "port")):
        def recording(mesh, g, cfg, *a, _solve=mod.distributed_gnc_optimize,
                      _seen=graphs[key], **kw):
            _seen.append({f: _np(v) for f, v in g._asdict().items()})
            return _solve(mesh, g, cfg, *a, **kw)
        monkeypatch.setattr(mod, "distributed_gnc_optimize", recording)

    class RecordingNode(jnode.SwarmNode):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jnode, "SwarmNode", RecordingNode)
    try:
        jelected, jshared = jentry._dryrun_protocol_on_mesh(
            jmake_mesh(4), "shard", 4)
    finally:
        for node in made:  # the reference node has no close()
            node.backend._executor.shutdown(wait=True)
    out = dryrun_multichip(4, device="cpu")
    run = out["protocol"]
    assert (run.survivor_optimizer, run.shared_estimates) == \
        (jelected, jshared)
    assert run.optimizers[0] == 0 and run.optimizers[1] != 0
    counts = {n.robot_id: n.backend.optimization_count for n in made}
    assert counts == {r: run.optimizers.count(r) for r in range(4)}
    # the port's first solve is the dry run's stage 3
    assert len(graphs["ref"]) == 3 and len(graphs["port"]) == 4
    for f, v in graphs["ref"][0].items():
        np.testing.assert_allclose(graphs["port"][1][f], v, atol=1e-6,
                                   err_msg=f)
    for node in made:
        assert set(run.estimates[node.robot_id]) == \
            set(node.backend.current_pose_estimates)
    first = graphs["ref"][0]
    jres = jdist.distributed_gnc_optimize(
        jmake_mesh(4), jfg.GraphArrays(**first),
        jpgo.PGOConfig(**CONVERGED))
    with make_swarm_mesh(4, device="cpu") as mesh:
        tres = tdist.distributed_gnc_optimize(
            mesh, tfg.GraphArrays(**{f: torch.as_tensor(v)
                                     for f, v in first.items()}),
            tpgo.PGOConfig(**CONVERGED))
    assert tres.gnc_iters == int(jres.gnc_iters)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-3)
    np.testing.assert_allclose(_np(tres.weights), _np(jres.weights),
                               atol=1e-2)
    for f in ("R", "t"):
        np.testing.assert_allclose(_np(getattr(tres, f)),
                                   _np(getattr(jres, f)), atol=1e-3,
                                   err_msg=f)
    assert tuple(out["descriptors"].shape) == (8, 64)
    idx, sims = out["knn"]
    assert tuple(idx.shape) == (8, 4) and bool(torch.isfinite(sims).all())
    assert bool(torch.isfinite(out["pgo"].t).all())
    assert not multiprocessing.active_children()
