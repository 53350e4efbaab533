"""Multi-device parallel layer: meshes, sharded descriptor matching,
distributed pose-graph optimization.

Port of cslam_tpu/parallel. The reference distributes the dense math
over a `jax.sharding.Mesh` with XLA collectives; here a mesh is a
`torch.distributed` group (NCCL across cards, or gloo) whose rank 0 is
the calling process (`mesh.py`). Descriptor databases shard by row
(`sharded_knn.py`), pose-graph factors by factor (`distributed_pgo.py`).
The decentralized protocol (gossip, election, liveness) stays on hosts
(cslam_tpu_torch.comm).
"""

from cslam_tpu_torch.parallel.mesh import make_swarm_mesh  # noqa: F401
