"""Pose-graph optimization distributed over a mesh.

Port of cslam_tpu/parallel/distributed_pgo.py. Factor-parallel
decomposition: the between-factors are sharded across the ranks (each
robot's factor block contiguous, so robots map onto shards), the node
arrays and the prior are replicated. The solver IS the single-device
solver: every rank runs `backend/pgo.gnc_optimize_core` on its factor
shard with an `EdgeReduce` whose sum and max are all-reduces over the
group, so every Gauss-Newton matvec is local gather -> batched
(E/d, 6, 6) products -> scatter-add -> all-reduce of the (P, 6) state,
and the preconditioner's blocks are all-reduced once per LM solve.

Every host decision of the core (CG stop, LM accept, GNC convergence,
the prior row) reads a reduced or replicated value, so the ranks take
the same branches; each rank reports its GNC round count, final cost and
a checksum of its poses, and rank 0 raises if any differs from its own.
"""

import torch

from cslam_tpu_torch.backend import pgo as pgo_mod
from cslam_tpu_torch.backend.factor_graph import FactorGraph, GraphArrays
from cslam_tpu_torch.parallel.mesh import Collectives, SwarmMesh

_EDGE_F = 50  # packed float columns of a factor: R 9, t 3, info 36, masks 2


def _pack(g: GraphArrays):
    P, E = g.R.shape[0], g.e_i.shape[0]
    nodes = torch.cat([g.R.reshape(P, 9), g.t, g.node_mask[:, None]], 1)
    edges_f = torch.cat([g.R_meas.reshape(E, 9), g.t_meas,
                         g.sqrt_info.reshape(E, 36), g.edge_mask[:, None],
                         g.is_loop[:, None]], 1)
    edges_i = torch.stack([g.e_i, g.e_j], 1).to(torch.int32)
    prior = (int(g.prior_idx), g.prior_R.cpu().numpy(),
             g.prior_t.cpu().numpy(), float(g.prior_weight))
    return nodes.float().contiguous(), edges_f.float().contiguous(), \
        edges_i.contiguous(), prior


def _solve(col: Collectives, cfg, P, E, prior, nodes=None, edges_f=None,
           edges_i=None):
    """The SPMD body: this rank's factor shard through the core."""
    S = E // col.size
    nodes = col.broadcast(nodes, (P, 13), torch.float32)
    ef = col.scatter(None if edges_f is None else list(edges_f.split(S)),
                     (S, _EDGE_F), torch.float32)
    ei = col.scatter(None if edges_i is None else list(edges_i.split(S)),
                     (S, 2), torch.int32)
    dev = col.device
    pi, pR, pt, pw = prior
    gl = GraphArrays(
        R=nodes[:, :9].reshape(P, 3, 3).contiguous(),
        t=nodes[:, 9:12].contiguous(), node_mask=nodes[:, 12].contiguous(),
        e_i=ei[:, 0].contiguous(), e_j=ei[:, 1].contiguous(),
        R_meas=ef[:, :9].reshape(S, 3, 3).contiguous(),
        t_meas=ef[:, 9:12].contiguous(),
        sqrt_info=ef[:, 12:48].reshape(S, 6, 6).contiguous(),
        edge_mask=ef[:, 48].contiguous(), is_loop=ef[:, 49].contiguous(),
        prior_idx=torch.tensor(pi, dtype=torch.int32, device=dev),
        prior_R=torch.as_tensor(pR, dtype=torch.float32, device=dev),
        prior_t=torch.as_tensor(pt, dtype=torch.float32, device=dev),
        prior_weight=torch.tensor(pw, dtype=torch.float32, device=dev))
    red = pgo_mod.EdgeReduce(sum=col.sum, max=col.max)
    res = pgo_mod.gnc_optimize_core(gl, cfg, red=red)
    weights = col.all_gather(res.weights).reshape(E)
    summary = {"rank": col.rank, "device": str(dev),
               "gnc_iters": res.gnc_iters, "cost": float(res.cost),
               "t_sum": float(res.t.double().sum())}
    if col.rank:
        return summary
    return res._replace(weights=weights), summary


def _solve_on_mesh(mesh: SwarmMesh, g: GraphArrays, cfg, axis_name):
    """(rank 0's PGOResult, every rank's summary in rank order); raises
    if any rank ended otherwise than rank 0."""
    n_shards = mesh.shape[axis_name]
    E = g.e_i.shape[0]
    if E % n_shards:
        raise ValueError(f"{E} factors do not split over {n_shards} ranks")
    g = GraphArrays(*(x.to(mesh.device) for x in g))
    # Chordal init needs the FULL edge set: run it before sharding (the
    # same split as the single-device optimize() entry)
    if cfg.use_chordal_init:
        from cslam_tpu_torch.backend.initialization import \
            chordal_initialize
        R0, t0 = chordal_initialize(g)
        g = g._replace(R=R0, t=t0)
        cfg = cfg._replace(use_chordal_init=False)
    nodes, edges_f, edges_i, prior = _pack(g)
    (result, mine), theirs = mesh.run(
        _solve, cfg, g.R.shape[0], E, prior,
        local={"nodes": nodes, "edges_f": edges_f, "edges_i": edges_i})
    for s in theirs:
        if (s["gnc_iters"], s["cost"], s["t_sum"]) != \
                (mine["gnc_iters"], mine["cost"], mine["t_sum"]):
            raise RuntimeError(f"the replicated solve diverged across "
                               f"ranks: rank 0 {mine}, rank {s['rank']} {s}")
    return result, [mine] + theirs


def distributed_gnc_optimize(mesh: SwarmMesh, g: GraphArrays,
                             cfg: pgo_mod.PGOConfig = pgo_mod.PGOConfig(),
                             axis_name: str = "shard"):
    """GNC-LM solve with the factors sharded over `mesh`.

    Every rank runs backend/pgo.gnc_optimize_core on its factor shard
    with all-reduce sums and maxima; the poses stay replicated. Returns
    rank 0's PGOResult (weights gathered over all factors); raises if
    any rank ended on another GNC round count, cost or pose checksum.
    """
    return _solve_on_mesh(mesh, g, cfg, axis_name)[0]


def optimize(mesh: SwarmMesh, fg: FactorGraph,
             cfg: pgo_mod.PGOConfig = pgo_mod.PGOConfig()):
    """Host entry: robot-contiguous factor blocks (robots map onto the
    shard axis), the distributed solve, write-back of estimates."""
    g = fg.to_arrays(edge_bucket_multiple=mesh.size, sort_by_robot=True,
                     device=mesh.device)
    result = distributed_gnc_optimize(mesh, g, cfg, axis_name=mesh.axis_name)
    fg.update_estimates(result.R, result.t)
    return result
