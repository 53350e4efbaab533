"""Smoke run of the PyTorch/CUDA port (cslam_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own elapsed_s:
  1. device: card name, power limit, count; fp32 matmuls and cuDNN
     convolutions without TF32 after the port's resolve_device;
  2. build: the CUDA kernels, compiled with nvcc from the checkout, and
     the tensor-core (HMMA) instructions of each kernel in its SASS (the
     bf16 kernel must have them, the f32 kernel none: never TF32);
  3. kernel: every kernel against its plain PyTorch version on the card
     through the search entry point (the slice's own shapes, the
     launcher's D = 32 search, the headline 100k x 512 / B=256 shape in
     f32 and bf16, k above one
     pass, ragged batch, depth and n_valid on the tensor-core path,
     duplicate rows, back-to-back searches on one stream), then
     CUDA-event timings of the search, the plain version and a library
     call, and the search's host wall time per call; then the
     small-dense kernel (MAC's LOBPCG eigh, QR and SVD) at LOBPCG's
     shapes against its plain float64 version, and its CUDA-event times
     against the plain version's and torch.linalg's in float32; then
     `knn_host`: the host microseconds of one DescriptorDatabase search
     and add at the sim cells' shape, the torch path against the
     single-call search, alone and beside a thread of solve-like small
     CUDA ops (time_knn_host);
  4. slice: the device path at map scale — 4 robots x 1000 keyframes,
     512-d descriptors: kNN ingestion through the f32 kernel, 2 rounds
     of MAC selection (matrix-free Fiedler path, P = 4096), GNC-LM PGO;
     the kernel's launches are counted over this phase alone;
  5. path check: the same descriptors through the exact (non-kernel)
     search give the same candidate edges and similarities;
  6. bf16 ingest: the slice's 4000 descriptors ingested again with bf16
     storage, through the tensor-core kernel (launches counted over this
     ingestion alone), against the same ingestion through the plain
     version on the CPU and through the exact search;
  7. mission: the sim mission of tests/test_e2e_swarm.py through the swarm
     protocol (cslam_tpu_torch.sim_mission: SwarmNode, bus, gossip,
     broker election, brokerage, simulated verification, decentralized
     PGO on a worker thread) at 4 robots x 500 keyframes, 512-d
     descriptors: per-stage wall seconds, the f32 kernel's launches and
     the small-dense kernel's executions (a CUDA graph's replays
     included) over this phase alone, the protocol's counts, ATE per
     robot, the host time of one to_arrays of the aggregated graph. It
     runs under a watchdog that dumps every thread's stack and exits
     non-zero if the phase stalls, waits on each solve with a timeout,
     and fails if a non-daemon thread outlives it;
  8. descriptor: keyframe images through the global-descriptor path —
     GlobalDescriptorComponent built from params on the in-process bus
     (shipped CosPlace, ResNet-18 at full widths, crop 224, batches of
     64) for 4 robots x 1000 rendered 120x160 keyframes (a pool of 256
     distinct renders, cycled): images/s end to end, the host
     preprocessing share, the device ms per 64-image forward (CUDA
     events) against its operations bound, 8 of the descriptors against
     the same model on the CPU (bf16 and f32), and the NetVLAD forward;
  9. place_recognition: the reference's quality gates on the card with
     top-1 from DescriptorDatabase(method="pallas") (the kernel at
     D = 64 and D = 128): CosPlace recall@1 over 3 held-out worlds, and
     its margin over the same network at random init; NetVLAD + PCA
     recall@1; then a loop-closure detector built from params (no
     descriptor_model, so it builds CosPlace on the card) fed the
     descriptors robot 0 published and robot 1's as gossip, which must
     find every repeated view; the kernel's launches of this phase;
 10. visual: the learned visual mission (cslam_tpu_torch.visual_mission:
     RGBDHandler with the shipped SuperPoint and 3-layer LightGlue,
     GlobalDescriptorComponent with the shipped CosPlace, SwarmNode
     with the detector's searches on the kernel, the broker and
     decentralized GNC-LM PGO) at 4 robots x 100 rendered 120x160
     keyframes, 128 keypoints, under the mission's watchdog: per-stage
     seconds (render, SuperPoint extraction, descriptor, detection,
     verification, optimization), verifications and ms per verified pair
     (LightGlue, RANSAC/PnP), loop closures, ATE per robot, the kernel's
     launches over this phase alone; then 8 keyframes' SuperPoint and 8
     pairs' LightGlue, 3D-3D RANSAC and PnP RANSAC on the card against
     the same on the CPU, and the reference's shipped-weight gates
     (LightGlue F1 over raw matching, the offset revisit, inter-robot
     verification) on the card;
 11. visual_models: CUDA-event times of one SuperPoint forward at
     120x160 and 480x640, LightGlue at 3 layers / K = 128 (shipped) and
     9 layers / K = 1024 (Flax-default random init), each against its
     operations / bytes bound;
 12. lidar: the lidar mission (cslam_tpu_torch.lidar_mission:
     LidarHandler with the voxel grid, FPFH, RANSAC and GNC-ICP from the
     Scan Context yaw and FPFH seeds, SwarmNode with Scan Context place
     recognition, the broker and decentralized GNC-LM PGO) at 4 robots x
     40 poses in a 200-cluster world whose raw scans exceed the
     handler's 8192-point capacity, so that every registration runs at
     8192, under the mission's watchdog: keyframes, raw and voxelized
     cloud sizes, registrations by outcome, loop closures, per-stage
     seconds, ms per registration by stage (host spans), ICP iterations
     (one host sync each) per registration, ATE per robot, the kernel's
     launches (0: the lidar path does not search descriptors); then 2
     keyframe pairs' voxel grid, Scan Contexts, FPFH, GNC-ICP and whole
     registration on the card against the CPU, and CUDA-event times of
     one voxel_downsample, fpfh, nearest_neighbors and gnc_icp at
     N = 8192 against their operations / bytes bounds;
 13. g2o: benchmarks/pgo_sphere_bench.py's sphere graph (2500 poses)
     written with the port's write_g2o and solved by `python -m
     cslam_tpu_torch.tools.solve_g2o in.g2o -o out.g2o --chordal` on the
     card in a child process under a hard deadline: the CLI's JSON (its
     platform must be cuda, its final cost below the initial), the
     process's wall seconds, and the ATE of the re-read output against
     the ground truth, which must be far below the odometry's;
 14. launch: four `python -m cslam_tpu_torch.launch --robot-id i` robot
     processes on the card over the C++ TCP bus (the synthetic world at
     the launcher's D = 32, 200 keyframes each, periodic checkpoints,
     the native logger); robot 1 is killed with SIGKILL once its
     checkpoint holds a third of its keyframes and restarted with
     --resume. Every child runs in its own session with its output in a
     file and a hard deadline, past which every robot's process group is
     killed and the phase fails with the tails of their logs. Per robot:
     device, keyframes, closures, optimizations, comm bytes, the
     kernel's launches, detection and optimization tick latencies, ATE;
     every robot on cuda:0 with launches, closures and an optimized ATE
     below its odometry's, robot 1 resumed and verifying new closures,
     no child left;
 15. training: each of the four trainers (SuperPoint, LightGlue,
     CosPlace, NetVLAD) takes one step of its build_train_step at f32 on
     the card and on the CPU from the same weights and host batch (loss
     1e-4 relative, gradients 1e-4 relative norm, the update where the
     gradient is clear of zero), then TRAIN_STEPS steps through its
     main code path (`train`) on the card at the reference CLI's shapes:
     device ms per step (CUDA events) and host batch ms against the
     step's bound (three forwards' operations over the card's peak), the
     loss trajectory and a learning gate whose threshold comes from the
     reference trainer's run (LEARNING_MAX_RATIO), the checkpoint's keys
     and shapes against the shipped file's and its reload through the
     port's wrapper on the card (the NetVLAD PCA fitted and saved too);
     then homographic adaptation (48 warps) from the shipped SuperPoint
     on the card against the CPU on real frames;
 16. tooling: `python -m cslam_tpu_torch.tools.kitti_eval` on the card in
     child processes under a hard deadline, on
     tests/test_eval_artifacts.py's fixture trajectory at 4 robots (the
     test's other arguments), then its CNN path (--images on the real
     frames, the shipped CosPlace): platform cuda, optimizations and
     verified closures >= 1, merged ATE improved, the kernel launched;
     then tests/test_real_pixels.py's and tests/test_tum_sequence.py's
     gates on the card (the readers, SuperPoint on real pixels, the
     verified intra-robot and inter-robot revisits with the reference's
     pose tolerances, CosPlace and NetVLAD ranking the revisit, the TUM
     path's revisit), and the digest of the decoded frames against the
     CPU tests' decoder's;
 17. multichip: the four stages of cslam_tpu_torch.entry's multi-device
     dry run at full width on meshes of ranks (cslam_tpu_torch.parallel,
     rank 0 in this process, the others spawned, each in its own
     session with its log in a file), under a watchdog: d = 4 sharing
     cuda:0 over gloo, d = 1 over NCCL, and d = device_count over NCCL
     (one card per rank) where there are 2 cards or more. Per mesh:
     worker start-up seconds, every rank's backend and device; the
     kernel table's headline (100,352 x 512, n_valid 100,000, B = 256,
     k = 10) in f32 and bf16 and the reference test's boundary n_valid,
     sharded through the kernel in every rank against the single-card
     kernel search (sims 1e-5, indices equal except among ties within
     1e-6), the kernel's launches gathered from every rank and the ms
     per sharded search; then (d > 1) the shipped CosPlace over 64
     images at crop 224 split over the ranks against the one-process
     forward; the slice's 4000-pose graph through the factor-sharded
     solve against the single card's (deterministic algorithms on rank
     0, each setting also solved with the factors in another order): at
     the slice's PGOConfig(15, 80) bit for bit on the one-rank mesh; on
     more ranks at a converged setting, the reference test's
     iteration-parity tolerances and ATE within 1e-3 m, with t within
     3x and GNC rounds within one of the single card's own spread (see
     multichip_pgo); (d > 1) the port's pgo_oracle on
     tests/test_pgo_oracle.py's graph at 200 poses against both solves
     and the elastic protocol (three mesh-sharded optimizations, robot
     0 dying and rejoining); children_left must be 0. Then CUDA-event
     times of the kernel at a shard (25,088 rows) and at the whole
     database. The single-card solves come first, as the phase
     `multichip_reference` under a watchdog of its own;
then the kernels line, the card line, and the result line.

    python3 chip_smoke.py --only multichip

runs phases 1, 2, the slice (for its pose graph) and 17 alone, then the
card line and the result line; with two cards or more, phase 17 runs
only the NCCL mesh of one rank per card (the one-card meshes are the
whole script's). `--only training`, `--only tooling` and `--only
knn_host` run phases 1, 2 and that phase. `--only lightglue_graph`
runs phases 1, 2 and `lightglue_graph` (in no other run): the host and
device ms of one LightGlue pair at the stereo cell's shape (9 layers,
K = 2,048), the eager pass against the pair graph's replay, alone and
beside the solve-like thread, and the capture's seconds
(time_lightglue_graph).

Exits non-zero, printing no result, without a CUDA card, without the
package, or when any phase fails. Uses no JAX.
"""

import contextlib
import faulthandler
import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# cuBLAS reads this when it first makes a workspace: the multichip
# phase's solves run with deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent
SEED = 0
HEADLINE = dict(n_cap=131072, n_valid=100000, dim=512, batch=256, k=10)
# the slice's own search shape: one robot's database after ingestion
# (1000 keyframes in a 1024-row buffer), one query, best match only
MAIN_SHAPE = dict(n_cap=1024, n_valid=1000, dim=512, batch=1, k=1)
# MAC selection rounds of the slice phase: 8 before the visual phases
# came, cut to 4 for them and to 2 for the launch phase, to keep the
# script in its time limit (PERF.md §4)
SLICE_ROUNDS = 2
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
HBM_BYTES_PER_S = 3.35e12
# float64: the CUDA cores' FMA rate (the small-dense kernel's arithmetic)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float64: 34e12}
KNN_REPLACES = "cslam_tpu/ops/knn_pallas.py:77"
KNN_SOURCE = "cslam_tpu_torch/csrc/cosine_topk.cu"
# exact path vs kernel on bf16 storage: the reference's own bound
# between its two bf16 lowerings (the exact path rounds the raw query to
# bf16, the kernel the normalized one; tests/test_torch_knn.py)
BF16_LOWERINGS_TOL = 5e-3
# the mission phase: benchmarks/SCALE_MISSION.json's shape cut from 4 x
# 1000 to 4 x 500 for the script's time limit, the sim mission's
# settings; a stalled phase is ended by the watchdog
MISSION = dict(n_robots=4, n_poses=500, descriptor_dim=512)
MISSION_WATCHDOG_S = 480
# the descriptor phase: the mission's keyframe count, rendered views
# (a pool cycled with a per-robot offset), the component's batches
DESCRIPTOR = dict(n_robots=4, keyframes_per_robot=1000, pool=256,
                  batch_size=64, robot_offset=64)
# descriptors against the same model on the CPU: the tolerances of
# tests/test_torch_models.py (f32 max abs; bf16 max abs and cosine)
MODEL_TOL = {torch.float32: (1e-5, None), torch.bfloat16: (2e-3, 0.9999)}
# the descriptor models' searches, timed beside the slice's
DESC_SHAPES = {
    # the detector's intra-robot search over 1000 CosPlace keyframes
    "detector_d64_f32": (dict(n_cap=1024, n_valid=1000, dim=64, batch=1,
                              k=5), torch.float32),
    "detector_d64_bf16": (dict(n_cap=1024, n_valid=1000, dim=64, batch=1,
                               k=5), torch.bfloat16),
    # recall@1: every view of a world against the others (top-2)
    "recall_d64_f32": (dict(n_cap=1024, n_valid=48, dim=64, batch=48, k=2),
                       torch.float32),
    "recall_d128_f32": (dict(n_cap=1024, n_valid=32, dim=128, batch=32,
                             k=2), torch.float32),
    # a launcher robot's search: one database after the launch phase's
    # mission (200 keyframes of D = 32 in the database's 1024-row
    # buffer), the best match of one descriptor
    "launcher_d32_f32": (dict(n_cap=1024, n_valid=200, dim=32, batch=1,
                              k=1), torch.float32),
}


# the visual phase: 4 robots as every other phase, 100 keyframes each,
# the reference visual mission's settings otherwise
VISUAL = dict(n_robots=4, n_poses=100)
VISUAL_WATCHDOG_S = 480
VISUAL_CHECK_PAIRS = 8
# card against CPU in the visual phase: SuperPoint descriptors (f32;
# bf16 max abs and cosine), heatmaps (f32; bf16: a softmax of logits
# whose bf16 inputs round at other places, tests/test_torch_
# visual_models.py), LightGlue scores on valid entries (max abs), RANSAC
# poses. Each reduced-precision control (SuperPoint's f32 heads computed
# in bf16, LightGlue's products in TF32) must exceed its bound.
SP_TOL = {torch.float32: (1e-5, 1e-5, None),
          torch.bfloat16: (2e-3, 3e-3, 0.9999)}
SCORE_TOL = 1e-4
# the CPU parity test's bound against the reference on real features,
# 1e-4 + 2e-6 |score| (tests/test_torch_visual_models.py), read beside
# the TF32 control
SCORE_REL_TOL = 2e-6
POSE_TOL = 1e-4
# the lidar phase: 4 robots as every other phase, 40 poses each, in a
# world (n_clusters, extent, sensor_range) whose raw scans exceed the
# lidar handler's capacity, so that every registration runs at it
LIDAR = dict(n_robots=4, n_poses=40, world=(200, 30.0, 20.0))
LIDAR_CAPACITY = 8192
LIDAR_WATCHDOG_S = 480
# keyframe pairs of the phase, ((robot, pose), (robot, pose)), checked
# card against CPU: a revisit of one robot and one across robots (cut
# from four pairs for the script's time limit)
LIDAR_CHECK_PAIRS = (((0, 0), (0, 39)), ((0, 20), (1, 10)))
# card against CPU: voxel centroids; FPFH values, and the share of rows
# whose 16 neighbours agree; ICP and registration poses
LIDAR_CENTROID_TOL = 1e-6
LIDAR_FPFH_TOL = 1e-4
LIDAR_FPFH_ROWS = 0.995
LIDAR_POSE_TOL = 1e-3
# the g2o phase: benchmarks/pgo_sphere_bench.py's sphere graph (2500
# poses, rings of 50, 0.02 measurement noise, seed 0), solved by the
# solve_g2o CLI in a child process under a hard deadline; the solve must
# bring the ATE below this share of the odometry's (the reference
# records 28.8 m -> 0.106 m, benchmarks/PGO_SPHERE.json)
SPHERE = dict(n=2500, ring=50, meas_noise=0.02, seed=0)
SPHERE_ATE_SHARE = 0.1
G2O_DEADLINE_S = 300
# the launch phase: four robot processes of `python -m
# cslam_tpu_torch.launch` on the card over the TCP bus, the synthetic
# world at the launcher's own width (D = 32), one keyframe per 0.1 s;
# robot 1 is killed once its checkpoint holds LAUNCH_KILL_AT_KF
# keyframes (a third of its stream) and restarted with --resume for the
# rest of the mission. The mission outlasts the protocol's own recovery:
# an optimizer that asked the killed robot for its pose graph waits
# backend.max_waiting_time_sec (60 s) before its next round, so 100 s
# leave a round with every robot after it (at 75 s the last solve could
# predate it). The resumed robot must not outlive its peers: a robot
# left with no neighbour solves its own graph alone, odometry only, and
# adopts that. So its duration ends LAUNCH_END_MARGIN_S before the
# earliest peer's (each robot's loop starts when its first checkpoint
# appears), which covers its own start-up. Every child gets its duration
# plus LAUNCH_STARTUP_S (interpreter, torch, CUDA context, libraries)
# before it is killed. The robots solve with --pgo-chordal: initialized
# from odometry (and the last round's estimates), PGOConfig's capped
# solve of the swarm graph drops exact closures and robot 0's ATE came
# out anywhere from 0.137 m to above its odometry's 0.769 m (PERF.md
# §6, tools/swarm_solve.py).
LAUNCH = dict(robots=4, sim_poses=200, sim_kf_period=0.1, duration=100.0,
              base_port=21700, checkpoint_period=1.0, device="cuda")
LAUNCH_KILL_AT_KF = 66
LAUNCH_END_MARGIN_S = 20.0
LAUNCH_STARTUP_S = 90.0
# multichip phase: the four stages of cslam_tpu_torch.entry.dryrun_multichip
# at full width on meshes of ranks (gloo on one card, NCCL one card per
# rank); the kernel table's headline split over 4 shards of 25,088 rows
MULTICHIP = dict(ranks=4, n_cap=100352, n_valid=100000, dim=512, batch=256,
                 k=10)
MULTICHIP_BOUNDARY = dict(n_cap=256, dim=16, batch=1, k=3,
                          n_valid=(1, 32, 33, 128, 255, 256))
MULTICHIP_SEARCH_TOL = 1e-5   # sims, sharded vs single-card kernel search
MULTICHIP_TIE = 1e-6          # indices may differ only among such ties
MULTICHIP_IMAGES = 64         # data-parallel CosPlace batch, crop 224
MULTICHIP_DESC_TOL = {torch.float32: (1e-4, None),
                      torch.bfloat16: (2e-3, 0.9999)}
# tests/test_pgo_oracle.py's graph at 200 poses
MULTICHIP_ORACLE = dict(poses=200, loops=24, outlier_every=4)
# the slice's 4000-pose graph at a setting where its solve converges (LM
# stops on its own, CG mostly on its tolerance); at the slice's
# PGOConfig(15, 80) CG ends at its cap in every GNC and polish step, and
# where the solve stops depends on the order of the sums
MULTICHIP_CONVERGED = dict(lm_max_iters=30, cg_max_iters=400)
# t of two converged solves that sum in other orders, in units of the
# single card's own spread (the same factors in another order)
MULTICHIP_T_SPREAD = 3.0
MULTICHIP_SEARCH_ITERS = 20
MULTICHIP_WATCHDOG_S = 480


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name, t0, **fields):
    emit({"phase": name, "elapsed_s": round(time.perf_counter() - t0, 3),
          **fields})


def nvidia_smi_cards():
    """Every card's `name, power.limit` line from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [line.strip() for line in out.stdout.strip().splitlines()]


def nvidia_smi():
    return nvidia_smi_cards()[0]


def cuda_ms(fn, iters):
    """Mean device ms per call over `iters` calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_ms(fn, iters=20):
    """Mean device ms per launch of the port's cosine top-k kernels over
    `iters` calls of fn, from torch.profiler's CUDA activity; None when
    the profiler records no such kernel."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "topk_" in e.key]
    count = sum(e.count for e in events)
    if not count:
        return None
    return sum(e.device_time_total for e in events) / count / 1e3


def knn_bound_ms(n_valid, dim, batch, k, dtype):
    """Least time for the search on an H100: the bytes it must move
    (valid rows, raw f32 queries, f32 row norms, outputs) over HBM
    bandwidth vs its 2*B*n*D operations over the dtype's peak; the larger
    bounds."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (n_valid * dim * esize + batch * dim * 4 + n_valid * 4
              + batch * k * 8)
    flops = 2.0 * batch * n_valid * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sass_hmma_counts(lib_path):
    """{kernel function: HMMA instruction count} from cuobjdump -sass of
    the built library (cuobjdump from nvcc's toolkit)."""
    from cslam_tpu_torch import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def check_search(kp, data, n_valid, queries, k, norms=None):
    """The search entry point on the card against the plain version on
    the same inputs; raises on disagreement. Returns (max_abs_err,
    (indices, sims) of the search)."""
    idx_k, val_k = kp.cosine_topk_pallas(data, n_valid, queries, k,
                                         data_norms=norms)
    inv, bias, q_n = kp.prepare_inputs(data, n_valid, queries, norms)
    idx_p, val_p = kp.cosine_topk_plain(data, n_valid, q_n, inv, bias, k)
    torch.cuda.synchronize()
    tol = TOL[data.dtype]
    what = (f"{tuple(data.shape)} n={n_valid} B={queries.shape[0]} k={k} "
            f"{data.dtype}")
    if idx_k.shape != (queries.shape[0], k):
        raise AssertionError(f"output shape {tuple(idx_k.shape)} at {what}")
    err = float((val_k - val_p).abs().max())
    if not err <= tol:
        raise AssertionError(f"sims differ by {err} > {tol} at {what}")
    n_eff = min(k, n_valid)
    full = (q_n.float() @ data.float().T) * inv + bias
    got = torch.gather(full, 1, idx_k[:, :n_eff].long())
    slot_err = float((got - val_k[:, :n_eff]).abs().max()) if n_eff else 0.0
    if not slot_err <= tol:
        raise AssertionError(f"kernel index does not carry its sim "
                             f"({slot_err} > {tol}) at {what}")
    if n_eff:
        srt = torch.sort(idx_k[:, :n_eff], dim=1)[0]
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise AssertionError(f"duplicate index in a top-k row at {what}")
        if bool((idx_k[:, :n_eff] >= n_valid).any()):
            raise AssertionError(f"kernel returned a padded row at {what}")
    if n_eff < k:
        if not (bool((val_k[:, n_eff:] == kp.NEG_LARGE).all())
                and bool((idx_k[:, n_eff:] == 0).all())):
            raise AssertionError(f"missing slots must hold -3e38 / 0 at "
                                 f"{what}")
    return max(err, slot_err), (idx_k, val_k)


def make_case(n_cap, n_valid, dim, batch, dtype, gen):
    dev = torch.device("cuda")
    data = torch.randn((n_cap, dim), generator=gen, device=dev).to(dtype)
    queries = torch.randn((batch, dim), generator=gen, device=dev)
    norms = torch.linalg.vector_norm(data.float(), dim=1)
    return data, n_valid, queries, norms


def check_knn_case(kp, n_cap, n_valid, dim, batch, k, dtype, gen):
    """One random case, kernel vs plain. Returns (inputs, max_abs_err)."""
    data, n_valid, queries, norms = make_case(n_cap, n_valid, dim, batch,
                                              dtype, gen)
    err, _ = check_search(kp, data, n_valid, queries, k, norms)
    return (data, queries, norms), err


def check_duplicates(kp, dtype, gen):
    """Exact duplicate rows tie exactly; the lower row comes first, also
    across the pass boundary of k = 100."""
    base = torch.randn((40, 64), generator=gen, device="cuda").to(dtype)
    data = torch.cat([base, base, base])
    queries = torch.randn((3, 64), generator=gen, device="cuda")
    err, (idx, val) = check_search(kp, data, 120, queries, 100)
    idx, val = idx.cpu().tolist(), val.cpu().tolist()
    for b in range(3):
        for j in range(99):
            if val[b][j] == val[b][j + 1] and not idx[b][j] < idx[b][j + 1]:
                raise AssertionError(f"tie not in row order: {dtype} "
                                     f"query {b} slot {j}")
        for j in range(0, 99, 3):
            trio = idx[b][j:j + 3]
            if trio != sorted(trio) or len({i % 40 for i in trio}) != 1:
                raise AssertionError(f"duplicates not together, lower "
                                     f"row first: {dtype} query {b} {trio}")
    return err


def check_back_to_back(kp, gen):
    """Searches of different shapes queued on one stream with no
    synchronize between them: each resets its counters for the next."""
    cases = [make_case(20000, 19000, 256, 70, torch.bfloat16, gen) + (10,),
             make_case(4096, 4000, 64, 3, torch.float32, gen) + (5,),
             make_case(20000, 19000, 256, 70, torch.bfloat16, gen) + (10,)]
    torch.cuda.synchronize()
    outs = [kp.cosine_topk_pallas(d, n, q, k, data_norms=nr)
            for d, n, q, nr, k in cases]
    worst = 0.0
    for (d, n, q, nr, k), (idx, val) in zip(cases, outs):
        inv, bias, q_n = kp.prepare_inputs(d, n, q, nr)
        _, val_p = kp.cosine_topk_plain(d, n, q_n, inv, bias, k)
        err = float((val - val_p).abs().max())
        if not err <= TOL[d.dtype]:
            raise AssertionError(f"back-to-back search {tuple(d.shape)} "
                                 f"differs by {err}")
        worst = max(worst, err)
    return worst


def compare_candidates(kernel, exact, threshold, tol=1e-5):
    """Tie-aware comparison of two candidate tables [(r0, k0, r1, k1, w)].

    The same edge must carry the same similarity within `tol`. An edge
    found by one search path only is explained when the other path
    found an edge from the same query keyframe to the same robot whose
    similarity is within `tol` (two rows tied within rounding; either
    is a correct best match), or when its similarity is within `tol` of
    the acceptance threshold."""
    a = {c[:4]: c[4] for c in kernel}
    b = {c[:4]: c[4] for c in exact}
    common = set(a) & set(b)
    sim_err = max((abs(a[e] - b[e]) for e in common), default=0.0)
    unexplained = [e for e in common if abs(a[e] - b[e]) > tol]

    def ends(e):
        return {((e[0], e[1]), e[2]), ((e[2], e[3]), e[0])}

    only = [(e, a, b) for e in set(a) - set(b)] + \
        [(e, b, a) for e in set(b) - set(a)]
    for e, mine, other in only:
        # the twin may also be an edge both paths found through another
        # search (mutual best matches), so look through all of `other`
        twins = [f for f in other
                 if f != e and ends(e) & ends(f)
                 and abs(other[f] - mine[e]) <= tol]
        if not twins and abs(mine[e] - threshold) > tol:
            unexplained.append(e)
    return {"same_edges": len(common), "only_kernel": len(set(a) - set(b)),
            "only_exact": len(set(b) - set(a)), "max_sim_err": sim_err,
            "tie_examples": [(e, mine[e]) for e, mine, _ in only[:6]],
            "unexplained": [list(e) for e in unexplained[:10]]}


def time_knn(kp, inputs, n_valid, k, iters):
    """Device ms of the search as DescriptorDatabase issues it (CUDA
    events over back-to-back calls, and the kernel's own device time per
    launch from the profiler), of the plain version and of the library
    yardstick; and the search's host wall ms per call over back-to-back
    calls (one synchronize)."""
    data, queries, norms = inputs

    def search():
        return kp.cosine_topk_pallas(data, n_valid, queries, k,
                                     data_norms=norms)

    ms = cuda_ms(search, iters)
    device_ms = kernel_device_ms(search)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        search()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    inv, bias, q_n = kp.prepare_inputs(data, n_valid, queries, norms)
    plain_ms = cuda_ms(
        lambda: kp.cosine_topk_plain(data, n_valid, q_n, inv, bias, k),
        max(iters // 5, 10))
    # library yardstick: one matmul + top-k over the scaled sims
    # (bf16 products on the tensor cores); the port never calls it
    lib_ms = cuda_ms(lambda: torch.topk(
        (q_n @ data.T).float() * inv + bias, k), iters)
    return ms, device_ms, host_ms, plain_ms, lib_ms


def timing_row(kp, inputs, shape, dtype, err, iters):
    ms, device_ms, host_ms, plain_ms, lib_ms = time_knn(
        kp, inputs, shape["n_valid"], shape["k"], iters)
    bound, bound_by = knn_bound_ms(shape["n_valid"], shape["dim"],
                                   shape["batch"], shape["k"], dtype)
    return {"shape": shape, "dtype": str(dtype), "max_abs_err": err,
            "ms": ms, "kernel_device_ms": device_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by}


# the matching layer's host path at the sim cells' shape (D = 512, f32,
# B = 1, k = 1, ~372 valid rows): calls of each variant per round, rounds
KNN_HOST = dict(dim=512, rows=372, calls=250, rounds=8, adds=48)


def _solve_like(stop, ops):
    """What the back-end's solve thread does to the host: small torch
    ops on the legacy default stream, each a GIL release, and a host
    read now and then; counts the ops it got through."""
    x = torch.ones(64, device="cuda")
    while not stop.is_set():
        for _ in range(50):
            x = x * 1.0001 + 1e-6
            ops[0] += 1
        float(x[0])
        ops[0] += 1


def _percentiles_us(times):
    q = np.percentile(np.asarray(times) * 1e6, [50, 90])
    return {"p50": float(q[0]), "p90": float(q[1])}


def time_knn_host(card):
    """Host microseconds of one descriptor search and one add as the sim
    cells issue them, the torch path against the single-call search
    (which holds the GIL through its call), alone and beside a thread of
    solve-like small CUDA ops; the variants interleave in rounds. Also
    the competing thread's ops per second beside each variant."""
    from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase

    cfg = KNN_HOST
    rng = np.random.default_rng(SEED)
    db = DescriptorDatabase(dim=cfg["dim"], device="cuda")
    for i in range(cfg["rows"]):
        db.add_item(rng.standard_normal(cfg["dim"]), i)
    queries = rng.standard_normal((64, cfg["dim"])).astype(np.float32)

    def old_search(q):
        return db._search_torch(q.reshape(1, -1), 1, 1)

    searches = {"torch_path": old_search,
                "single_call": lambda q: db._search(q, 1)}
    ref = old_search(queries[0])
    for name, fn in searches.items():  # warm, and the same answer
        got = fn(queries[0])
        if not (np.array_equal(got[0], ref[0]) and
                np.array_equal(got[1].view(np.int32), ref[1].view(np.int32))):
            raise AssertionError(f"{name} answers otherwise: {got} {ref}")

    # an add through torch ops, as before staging: a pageable upload of
    # the row, the norm written from a Python float (a buffer of its
    # own, the same shape)
    old_data = torch.zeros((1024, cfg["dim"]), device="cuda")
    old_norms = torch.zeros(1024, device="cuda")

    def old_add(v, i):
        row = torch.from_numpy(v).to(torch.float32)
        norm = float(np.linalg.norm(row.float().numpy()))
        old_data[i] = torch.as_tensor(row, device="cuda")
        old_norms[i] = norm

    adds = {"torch_path": old_add,
            "staged": lambda v, i: db.add_item(v, cfg["rows"] + i)}
    res = {}
    for setting in ("alone", "beside_solve_thread"):
        stop, ops = threading.Event(), [0]
        other = None
        if setting != "alone":
            other = threading.Thread(target=_solve_like, args=(stop, ops),
                                     daemon=True)
            other.start()
            time.sleep(0.2)
        times = {name: [] for name in searches}
        add_times = {name: [] for name in adds}
        rate = {name: [] for name in searches}
        for _ in range(cfg["rounds"]):
            for name, fn in searches.items():
                ops0, t_round = ops[0], time.perf_counter()
                for j in range(cfg["calls"]):
                    q = queries[j % len(queries)]
                    t = time.perf_counter()
                    fn(q)
                    times[name].append(time.perf_counter() - t)
                rate[name].append((ops[0] - ops0) /
                                  (time.perf_counter() - t_round))
            for name, fn in adds.items():
                for i in range(cfg["adds"]):
                    v = rng.standard_normal(cfg["dim"]).astype(np.float32)
                    t = time.perf_counter()
                    fn(v, i)
                    add_times[name].append(time.perf_counter() - t)
                db.n, db._flushed = cfg["rows"], cfg["rows"]  # drop them
                torch.cuda.synchronize()
        stop.set()
        if other is not None:
            other.join()
        res[setting] = {
            "search_us": {n: _percentiles_us(t) for n, t in times.items()},
            "add_us": {n: _percentiles_us(t) for n, t in add_times.items()},
        }
        if other is not None:
            res[setting]["solve_thread_ops_per_s"] = {
                n: float(np.median(r)) for n, r in rate.items()}
    return {"shape": {k: cfg[k] for k in ("dim", "rows")},
            "calls_per_variant": cfg["calls"] * cfg["rounds"],
            "card": card, **res}


# LightGlue at the stereo cell's shape: 9 layers, K = 2,048 padded with
# the valid counts its frames hold, 1241 x 376 images; pairs of each
# variant per round, rounds
LIGHTGLUE_GRAPH = dict(K=2048, valid=(1700, 1500), layers=9,
                       size=(1241, 376), calls=8, rounds=4)


def lightglue_pair(rng, k0, k1, n0, n1, size):
    """A padded LightGlue pair as StereoHandler passes it (numpy, the n0
    and n1 valid slots first, n1 <= n0, pixel keypoints in `size`):
    side 1 holds side 0's first keypoints shuffled, moved a little, with
    noisy descriptors, so a trained matcher finds matches."""
    desc0 = rng.standard_normal((k0, 256)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=1, keepdims=True)
    xy0 = (rng.random((k0, 2)) * size).astype(np.float32)
    perm = rng.permutation(n0)[:n1]
    desc1 = rng.standard_normal((k1, 256)).astype(np.float32)
    desc1[:n1] = desc0[perm] + 0.05 * desc1[:n1]
    desc1 /= np.linalg.norm(desc1, axis=1, keepdims=True)
    xy1 = (rng.random((k1, 2)) * size).astype(np.float32)
    xy1[:n1] = xy0[perm] + rng.normal(0, 0.5, (n1, 2))
    return (desc0, xy0, (np.arange(k0) < n0).astype(np.float32),
            desc1, xy1, (np.arange(k1) < n1).astype(np.float32))


def time_lightglue_graph(card):
    """Host and device ms of one LightGlue pair at the stereo cell's
    shape: the eager pass as the port ran it before the pair graph
    (default stream, six pageable uploads and the size's, a launch per
    kernel, the filter, the host copy) against LightGlue.match (one
    staged upload, one graph replay on the matcher's stream, the filter,
    one pinned copy), alone and beside a thread of solve-like small CUDA
    ops; the variants interleave in rounds. Device ms, per pair: the
    eager pass from CUDA events on the default stream before its first
    upload and after its last kernel (its launch gaps included), the
    replay from events around the graph alone (its kernels back to
    back: the pair's device time). Also the first pair's seconds
    (warm-up, capture, replay) and the capture span's, and both
    variants' matches, which must agree."""
    from cslam_tpu_torch.models.lightglue import LightGlue, \
        mutual_matches, normalize_keypoints
    from cslam_tpu_torch.runtime.tracing import tracer

    cfg = LIGHTGLUE_GRAPH
    lg = LightGlue(num_layers=cfg["layers"], rng_seed=SEED, device="cuda")
    rng, size, K = np.random.default_rng(SEED), cfg["size"], cfg["K"]
    pairs = [lightglue_pair(rng, K, K, *cfg["valid"], size)
             for _ in range(4)]

    def eager(args, events=None):
        if events is not None:
            events[0].record()
        d0, xy0, m0, d1, xy1, m1 = (lg._tensor(a) for a in args)
        with torch.no_grad():
            scores = lg.model(d0, normalize_keypoints(xy0, size), m0, d1,
                              normalize_keypoints(xy1, size), m1)
        best1, valid = mutual_matches(scores, lg._tensor(args[2]),
                                      lg.score_threshold)
        packed = torch.stack([best1.to(torch.float32),
                              valid.to(torch.float32)])
        if events is not None:
            events[1].record()
        out = packed.cpu().numpy()
        return out[0].astype(np.int32), out[1]

    tracer.clear()
    tracer.enable(None)
    try:
        t = time.perf_counter()
        lg.match(*pairs[0], size=size)
        first_pair_s = time.perf_counter() - t
        capture_s = tracer.totals()["lightglue_capture"]["seconds"]
    finally:
        tracer.disable()
        tracer.clear()
    for args in pairs:  # warm, and the same matches
        want, got = eager(args), lg.match(*args, size=size)
        if not (np.array_equal(want[0], got[0]) and
                np.array_equal(want[1], got[1])):
            raise AssertionError("LightGlue: the replay's matches differ "
                                 "from the eager pass's")
    (entry,) = lg._graphs.values()

    def replay_ms():
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(lg._stream):
            e0.record()
            entry.graph.replay()
            e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    res = {}
    for setting in ("alone", "beside_solve_thread"):
        stop, ops = threading.Event(), [0]
        other = None
        if setting != "alone":
            other = threading.Thread(target=_solve_like, args=(stop, ops),
                                     daemon=True)
            other.start()
            time.sleep(0.2)
        host = {"eager": [], "graph": []}
        device = {"eager": [], "graph": []}
        rate = {"eager": [], "graph": []}
        for _ in range(cfg["rounds"]):
            for name in ("eager", "graph"):
                ops0, t_round = ops[0], time.perf_counter()
                for j in range(cfg["calls"]):
                    args = pairs[j % len(pairs)]
                    if name == "eager":
                        events = [torch.cuda.Event(enable_timing=True)
                                  for _ in range(2)]
                        t = time.perf_counter()
                        eager(args, events)
                        host[name].append(time.perf_counter() - t)
                        device[name].append(
                            events[0].elapsed_time(events[1]))
                    else:
                        t = time.perf_counter()
                        lg.match(*args, size=size)
                        host[name].append(time.perf_counter() - t)
                        device[name].append(replay_ms())
                rate[name].append((ops[0] - ops0) /
                                  (time.perf_counter() - t_round))
        stop.set()
        if other is not None:
            other.join()
        res[setting] = {
            "host_ms": {n: {k: v / 1e3 for k, v in
                            _percentiles_us(t).items()}
                        for n, t in host.items()},
            "device_ms": {n: {k: float(v) for k, v in zip(
                ("p50", "p90"), np.percentile(d, [50, 90]))}
                for n, d in device.items()}}
        if other is not None:
            res[setting]["solve_thread_ops_per_s"] = {
                n: float(np.median(r)) for n, r in rate.items()}
    return {"shape": {k: cfg[k] for k in ("K", "valid", "layers", "size")},
            "pairs_per_variant": cfg["calls"] * cfg["rounds"],
            "first_pair_s": first_pair_s, "capture_s": capture_s,
            "card": card, **res}


# the small-dense kernel at LOBPCG's shapes (block k = 4): the
# Rayleigh-Ritz eigh (12 x 12, 3k), SVQB's eigh (4 x 4), the P update's
# QR (8 x 4) and the basis extension's SVD (4 x 4); batches of one, as
# LOBPCG launches them, and of 64; the minimal float64 operations of each
# factorization with its vectors (Golub and Van Loan: 9n^3 symmetric
# eigh, 4mn^2 - 4n^3/3 QR with Q, 21n^3 SVD with U and V)
SMALL_DENSE_SHAPES = {"eigh_12": ("eigh", 12, 12), "eigh_4": ("eigh", 4, 4),
                      "qr_8x4": ("qr", 8, 4), "svd_4": ("svd", 4, 4)}
SMALL_DENSE_TOL = 1e-6


def small_dense_flops(op, m, n):
    return {"eigh": 9 * n ** 3, "qr": 4 * m * n * n - 4 * n ** 3 / 3,
            "svd": 21 * n ** 3}[op]


def small_dense_inputs(op, m, n, batch, gen):
    A = torch.randn((batch, m, n), generator=gen, device="cuda")
    return (A + A.mT) / 2 if op == "eigh" else A


def check_small_dense(sd, gen):
    """Each small-dense kernel on card tensors at LOBPCG's shapes against
    its plain float64 version: eigenvalues and singular values, and the
    products V diag(w) V^T, Q R and U diag(S) V^T against the matrix, each
    within SMALL_DENSE_TOL of the matrix's largest entry. Returns the
    worst of those errors; raises above the tolerance."""
    worst = 0.0
    for name, (op, m, n) in SMALL_DENSE_SHAPES.items():
        for batch in (1, 64):
            A = small_dense_inputs(op, m, n, batch, gen)
            A64 = A.double()
            scale = float(A.abs().max())
            errs = {}
            if op == "eigh":
                w, V = sd.eigh(A)
                errs["values"] = w.double() - sd.eigh_plain(A64)[0]
                V = V.double()
                errs["product"] = V @ torch.diag_embed(w.double()) @ V.mT \
                    - A64
            elif op == "qr":
                Q, R = sd.qr(A)
                errs["product"] = Q.double() @ R.double() - A64
            else:
                U, S, Vh = sd.svd(A)
                errs["values"] = S.double() - sd.svd_plain(A64)[1]
                errs["product"] = (U.double() @ torch.diag_embed(S.double())
                                   @ Vh.double() - A64)
            for what, e in errs.items():
                err = float(e.abs().max()) / scale
                worst = max(worst, err)
                if not err <= SMALL_DENSE_TOL:
                    raise AssertionError(
                        f"small-dense {name} batch {batch}: {what} off "
                        f"by {err:.3g} of the largest entry")
    return worst


def time_small_dense(sd, gen):
    """Per LOBPCG shape (batch of one): device ms a call of the kernel's
    wrapper, of its plain float64 version and of torch.linalg in float32
    (which reads cuSOLVER's status back to the host), CUDA events over
    back-to-back calls; and the bound, the larger of the bytes over HBM
    bandwidth and the float64 operations over the card's FMA peak."""
    rows = {}
    for name, (op, m, n) in SMALL_DENSE_SHAPES.items():
        A = small_dense_inputs(op, m, n, 1, gen)[0]
        kernel, plain, library = {
            "eigh": (sd.eigh, sd.eigh_plain, torch.linalg.eigh),
            "qr": (sd.qr, sd.qr_plain, torch.linalg.qr),
            "svd": (sd.svd, sd.svd_plain, torch.linalg.svd)}[op]
        out_words = {"eigh": n * n + n, "qr": m * n + n * n,
                     "svd": 2 * n * n + n}[op]
        t_bytes = (m * n + out_words) * 4 / HBM_BYTES_PER_S * 1e3
        t_ops = small_dense_flops(op, m, n) / PEAK_FLOPS[torch.float64] \
            * 1e3
        rows[name] = {
            "ms": cuda_ms(lambda: kernel(A), 200),
            "plain_ms": cuda_ms(lambda: plain(A), 50),
            "library_ms": cuda_ms(lambda: library(A), 50),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return rows


def reset_launches(kp):
    for name in kp.cosine_topk_pallas.launches:
        kp.cosine_topk_pallas.launches[name] = 0


def live_non_daemon_threads():
    """Threads other than the main one that would keep the interpreter
    from exiting."""
    return [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon
            and t.is_alive()]


def check_mission(res):
    """The mission phase's gates; raises on the first that fails."""
    if res["knn_launches"]["cosine_topk_f32"] <= 0:
        raise AssertionError("the mission never launched the f32 kernel")
    if not res["fixed_edges"]:
        raise AssertionError("the mission verified no loop closure")
    if res["optimization_count"][0] < 1:
        raise AssertionError("robot 0 (the optimizer) never optimized")
    # every robot that received estimates for all its poses improves on
    # its odometry; robot 1 must be among them (tests/test_e2e_swarm.py)
    with_estimates = [r for r, (_, opt) in res["ate"].items()
                      if opt is not None]
    if 1 not in with_estimates:
        raise AssertionError(f"robot 1 received no estimates "
                             f"(robots with estimates: {with_estimates})")
    for rid in with_estimates:
        odo, opt = res["ate"][rid]
        if not opt < odo:
            raise AssertionError(f"robot {rid}: optimized ATE {opt} is not "
                                 f"below odometry ATE {odo}")
    if sum(res["small_dense_launches"].values()) <= 0:
        raise AssertionError("the mission's MAC never ran the small-dense "
                             "kernel")
    if res["threads_left"]:
        raise AssertionError(f"non-daemon threads outlived the mission: "
                             f"{res['threads_left']}")


def forward_flops(model, x):
    """Operations (2 x multiply-adds) of one forward of `model` over x,
    from the shapes its conv, linear and NetVLAD layers see (forward
    hooks); elementwise work is not counted."""
    from cslam_tpu_torch.models.netvlad import NetVLADLayer
    counts = []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] * \
                m.kernel_size[1]
            counts.append(2 * out.numel() * k)
        elif isinstance(m, torch.nn.Linear):
            counts.append(2 * out.numel() * m.in_features)
        else:  # assignment conv + weighted residual sum, K x C per pixel
            b, c, h, w = inp[0].shape
            counts.append(2 * 2 * b * h * w * c * m.num_clusters)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                               NetVLADLayer))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return float(sum(counts))


def model_bound_ms(flops, nbytes):
    """Least time of a forward at the card's dense bf16 tensor-core peak
    vs its bytes (input, weights, output once) over HBM bandwidth."""
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def render_pool(n, seed):
    """n grey 120x160 renders of one world from random places."""
    from cslam_tpu_torch.models.train_cosplace import make_world, \
        render_view
    rng = np.random.default_rng(seed)
    world = make_world(seed, n=160)
    return [render_view(world, (rng.uniform(-3.0, 3.0),
                                rng.uniform(-2.5, 2.5)), rng, 0.35, 0.06)
            for _ in range(n)]


def check_descriptors(card, cpu, dtype, what):
    """Raise unless card descriptors agree with the CPU's within
    MODEL_TOL; returns (max abs difference, min cosine)."""
    atol, min_cos = MODEL_TOL[dtype]
    err = float(np.abs(card - cpu).max())
    cos = float(np.min(np.sum(card * cpu, axis=1)))
    if not np.isfinite(card).all() or not err <= atol or \
            (min_cos is not None and not cos >= min_cos):
        raise AssertionError(f"{what}: card vs CPU max abs {err}, "
                             f"min cosine {cos}")
    return err, cos


def time_forward(fn, iters=20):
    """Device ms of one call of fn (a forward over a batch already on the
    card; CUDA events)."""
    with torch.no_grad():
        return cuda_ms(fn, iters)


def run_descriptor_phase(card):
    """Phase 8; returns (per-robot published descriptors, the components,
    the phase's fields)."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter
    from cslam_tpu_torch.frontend.global_descriptor_component import \
        GlobalDescriptorComponent
    from cslam_tpu_torch.models.cosplace import CosPlace, \
        GeoLocalizationNet, embed, preprocess, to_device
    from cslam_tpu_torch.models.netvlad import NetVLAD
    from cslam_tpu_torch.runtime.tracing import tracer

    d = DESCRIPTOR
    n_robots, n_kf, bsz = (d["n_robots"], d["keyframes_per_robot"],
                           d["batch_size"])
    t = time.perf_counter()
    pool = render_pool(d["pool"], SEED + 1)
    render_s = time.perf_counter() - t
    t = time.perf_counter()
    router = InProcessRouter()
    published = {r: [] for r in range(n_robots)}
    buses, comps = [], []
    for r in range(n_robots):
        bus = InProcessBus(router, r)
        router.subscribe(f"/r{r}/cslam/processed_global_descriptor",
                         published[r].append)
        buses.append(bus)
        comps.append(GlobalDescriptorComponent(
            {"robot_id": r, "frontend.global_descriptor_technique":
             "cosplace", "frontend.nn_checkpoint": "shipped"},
            bus, batch_size=bsz))
    model = comps[0].model
    if not (model.enabled and next(model.model.parameters()).is_cuda):
        raise AssertionError("the config path did not load the shipped "
                             "CosPlace onto the card")
    # warm-up: cuDNN's first calls at the batch's and the tail's sizes
    for n in (bsz, n_kf % bsz or bsz):
        model.compute_embeddings_batch(np.stack(
            [np.broadcast_to(im[..., None], im.shape + (3,))
             for im in pool[:n]]))
    setup_s = time.perf_counter() - t

    def view(r, kid):
        return pool[(kid + d["robot_offset"] * r) % len(pool)]

    tracer.clear()
    tracer.enable(None)  # record spans in memory only
    torch.cuda.synchronize()
    t = time.perf_counter()
    for start in range(0, n_kf, bsz):
        for r, bus in enumerate(buses):
            for kid in range(start, min(start + bsz, n_kf)):
                bus.publish("cslam/keyframe_data",
                            msgs.KeyframeRGB.from_image(kid, view(r, kid)))
        router.spin_until_idle()
    for gdc in comps:
        gdc.tick()
    router.spin_until_idle()
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t
    spans = tracer.totals()
    tracer.disable()
    tracer.clear()

    for r in range(n_robots):
        got = published[r]
        if [m.keyframe_id for m in got] != list(range(n_kf)) or \
                any(m.robot_id != r for m in got):
            raise AssertionError(f"robot {r} published {len(got)} "
                                 f"descriptors, not keyframes 0..{n_kf - 1}")
    emb = np.stack([np.asarray(m.descriptor) for r in range(n_robots)
                    for m in published[r]])
    norms = np.linalg.norm(emb, axis=1)
    if emb.shape != (n_robots * n_kf, model.fc_output_dim) or \
            not np.isfinite(emb).all() or \
            not np.allclose(norms, 1.0, atol=1e-4):
        raise AssertionError(f"descriptors: shape {emb.shape}, norms "
                             f"{norms.min()}..{norms.max()}")
    forwards = spans["descriptor_forward"]["count"]
    if forwards != n_robots * -(-n_kf // bsz):
        raise AssertionError(f"{forwards} forwards for {n_robots} x "
                             f"{n_kf} keyframes in batches of {bsz}")

    # 8 of those keyframes against the same model on the CPU; and the
    # same network with f32 convs, card against CPU
    sample = np.stack([np.broadcast_to(view(0, k)[..., None],
                                       (120, 160, 3)) for k in range(8)])
    params = {"frontend.nn_checkpoint": "shipped"}
    cpu_check = {}
    on_cpu = CosPlace(params, device="cpu").compute_embeddings_batch(sample)
    err, cos = check_descriptors(emb[:8], on_cpu, torch.bfloat16,
                                 "CosPlace bf16")
    cpu_check["torch.bfloat16"] = {"max_abs_err": err, "min_cosine": cos}
    state = model.model.state_dict()
    f32 = {}
    for dev in ("cpu", "cuda"):
        net = GeoLocalizationNet(model.fc_output_dim, dtype=torch.float32)
        net.load_state_dict(state)
        f32[dev] = embed(net.eval().to(dev), preprocess(sample, 224),
                         torch.device(dev))
    err, cos = check_descriptors(f32["cuda"], f32["cpu"], torch.float32,
                                 "CosPlace f32")
    cpu_check["torch.float32"] = {"max_abs_err": err, "min_cosine": cos}

    # device time per batch of 64 at crop 224, and the NetVLAD forward
    batch_np = preprocess(np.stack([np.broadcast_to(
        im[..., None], im.shape + (3,)) for im in pool[:bsz]]), 224)
    x = to_device(batch_np, torch.device("cuda"))
    h2d_ms = cuda_ms(lambda: to_device(batch_np, torch.device("cuda")), 20)
    flops = forward_flops(model.model, x)
    nbytes = x.numel() * 4 + sum(p.numel() * 4 for p in
                                 model.model.parameters()) + bsz * 64 * 4
    bound, bound_by = model_bound_ms(flops, nbytes)
    ms = time_forward(lambda: model.model(x))
    nv = NetVLAD(params, device="cuda")
    nv_batch = preprocess(np.stack([np.broadcast_to(
        im[..., None], im.shape + (3,)) for im in pool[:bsz]]), nv.crop_size)
    xn = to_device(nv_batch, torch.device("cuda"))
    nv_flops = forward_flops(nv.model, xn) + 2.0 * bsz * 128 * 64 * 512
    nv_bytes = xn.numel() * 4 + 4 * (
        sum(p.numel() for p in nv.model.parameters())
        + nv.pca_components.numel() + nv.pca_mean.numel()) + bsz * 128 * 4

    def nv_forward():
        out = nv.model(xn)
        return (out - nv.pca_mean) @ nv.pca_components.T

    nv_bound, nv_bound_by = model_bound_ms(nv_flops, nv_bytes)
    nv_ms = time_forward(nv_forward)
    fields = dict(
        robots=n_robots, keyframes_per_robot=n_kf, image="120x160 grey",
        crop=model.crop_size, descriptor_dim=model.fc_output_dim,
        batch_size=bsz, pool_views=len(pool), pool_render_s=render_s,
        setup_s=setup_s, e2e_s=e2e_s,
        images_per_s=n_robots * n_kf / e2e_s,
        host_preprocess_s=spans["descriptor_preprocess"]["seconds"],
        host_preprocess_share=spans["descriptor_preprocess"]["seconds"]
        / e2e_s,
        forward_call_s=spans["descriptor_forward"]["seconds"],
        forward_call_share=spans["descriptor_forward"]["seconds"] / e2e_s,
        forwards=forwards,
        host_ms_per_batch={
            name: spans[f"descriptor_{name}"]["seconds"] / forwards * 1e3
            for name in ("preprocess", "forward")},
        cpu_check=cpu_check,
        cosplace_forward={"batch": bsz, "ms": ms, "h2d_ms": h2d_ms,
                          "flops": flops,
                          "bound_ms": bound, "bound_by": bound_by,
                          "tflops_per_s": flops / ms / 1e9},
        netvlad_forward={"batch": bsz, "crop": nv.crop_size, "ms": nv_ms,
                         "flops": nv_flops, "bound_ms": nv_bound,
                         "bound_by": nv_bound_by,
                         "tflops_per_s": nv_flops / nv_ms / 1e9},
        max_memory_allocated=torch.cuda.max_memory_allocated(), card=card)
    return published, comps, fields


def detector_params(robot_id, n_robots):
    return {"robot_id": robot_id, "max_nb_robots": n_robots,
            "frontend.global_descriptor_technique": "cosplace",
            "frontend.nn_checkpoint": "shipped",
            "frontend.similarity_threshold": 0.8,
            "frontend.nb_best_matches": 5,
            "frontend.intra_loop_min_inbetween_keyframes": 2,
            "frontend.enable_intra_robot_loop_closures": True,
            "frontend.inter_robot_loop_closure_budget": 5,
            "neighbor_management.enable_neighbor_monitoring": False,
            "neighbor_management.init_delay_sec": 0.0,
            "neighbor_management.max_heartbeat_delay_sec": 5.0}


def run_place_recognition(kp, published, cosplace):
    """Phase 9; returns its fields, raising on any gate."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend.loop_closure_detection import \
        GlobalDescriptorLoopClosureDetection
    from cslam_tpu_torch.models.cosplace import CosPlace
    from cslam_tpu_torch.models.netvlad import NetVLAD
    from cslam_tpu_torch.models.train_cosplace import eval_recall, \
        make_world, render_places, top1_recall

    t = time.perf_counter()
    trained = eval_recall(cosplace.model, seed=31337, n_places=24,
                          device="cuda")
    rand = CosPlace({"frontend.nn_checkpoint": "disable"}, rng_seed=3,
                    device="cuda")
    baseline = eval_recall(rand.model, seed=31337, n_places=24,
                           device="cuda")
    nv = NetVLAD({"frontend.nn_checkpoint": "shipped"}, device="cuda")
    nv_recalls = []
    for w in range(3):
        rng = np.random.default_rng(31337 + w)
        imgs, labels = render_places(rng, make_world(31337 + 17 * w, n=160),
                                     16, 2, 0.35, 0.06)
        nv_recalls.append(top1_recall(nv.compute_embeddings_batch(imgs),
                                      labels, "cuda"))
    nv_recall = float(np.mean(nv_recalls))
    recall_launches = dict(kp.cosine_topk_pallas.launches)
    recall_s = time.perf_counter() - t

    # the detector builds CosPlace itself; robot 0's published
    # descriptors arrive on its bus, robot 1's as one gossip message
    t = time.perf_counter()
    n_robots = len(published)
    router = InProcessRouter()
    bus = InProcessBus(router, 0)
    det = GlobalDescriptorLoopClosureDetection(
        detector_params(0, n_robots), bus, ManualClock(), device="cuda")
    model = det.global_descriptor
    if not (isinstance(model, CosPlace) and model.enabled and
            next(model.model.parameters()).is_cuda):
        raise AssertionError("the detector did not build the shipped "
                             "CosPlace on the card")
    intra = []
    router.subscribe("/r0/cslam/local_keyframe_match", intra.append)
    for m in published[0]:
        bus.publish("cslam/processed_global_descriptor", m)
        router.spin_until_idle()
    det.global_descriptor_callback(msgs.GlobalDescriptors(
        descriptors=published[1]))
    torch.cuda.synchronize()
    detector_s = time.perf_counter() - t
    launches = dict(kp.cosine_topk_pallas.launches)
    pool, offset = DESCRIPTOR["pool"], DESCRIPTOR["robot_offset"]
    repeats = {m.keyframe0_id: m.keyframe1_id for m in intra}
    n_kf = len(published[0])
    same_view = sum(1 for k in range(pool, n_kf)
                    if k in repeats and (k - repeats[k]) % pool == 0)
    inter = list(det.inter_robot_matches_buffer.values())
    inter_same = sum(1 for e in inter
                     if (e.robot0_keyframe_id - e.robot1_keyframe_id
                         - offset) % pool == 0)
    fields = dict(
        cosplace_recall_at_1=trained, cosplace_random_init=baseline,
        netvlad_pca_recall_at_1=nv_recall,
        netvlad_per_world=nv_recalls, recall_s=recall_s,
        recall_launches=recall_launches, detector_s=detector_s,
        intra_matches=len(intra), repeats_found=same_view,
        repeats=n_kf - pool, inter_matches=len(inter),
        inter_same_view=inter_same, gossiped=len(published[1]),
        knn_launches=launches)
    return fields


def check_place_recognition(res):
    """The place_recognition phase's gates (the reference's recall bars,
    tests/test_trained_cosplace.py and test_trained_netvlad.py); raises
    on the first that fails."""
    trained, baseline = res["cosplace_recall_at_1"], \
        res["cosplace_random_init"]
    if not (trained >= 0.85 and trained >= baseline + 0.2):
        raise AssertionError(f"CosPlace recall@1 {trained} (random init "
                             f"{baseline})")
    if not res["netvlad_pca_recall_at_1"] >= 0.9:
        raise AssertionError(f"NetVLAD recall@1 "
                             f"{res['netvlad_pca_recall_at_1']}")
    if res["recall_launches"]["cosine_topk_f32"] <= 0:
        raise AssertionError("recall@1 never launched the kernel")
    if res["repeats_found"] < 0.99 * res["repeats"]:
        raise AssertionError(f"the detector found {res['repeats_found']} "
                             f"of {res['repeats']} repeated views")
    if res["inter_same_view"] < 0.99 * res["gossiped"]:
        raise AssertionError(f"{res['inter_same_view']} of "
                             f"{res['gossiped']} gossiped descriptors "
                             f"matched their view")
    if res["knn_launches"]["cosine_topk_f32"] <= \
            res["recall_launches"]["cosine_topk_f32"]:
        raise AssertionError("the detector never launched the kernel")


def visual_frames(n_pairs, seed):
    """n_pairs (image, depth, pose) pairs of nearby views of the visual
    mission's world (a revisit within 0.2 m and 3 degrees)."""
    from cslam_tpu_torch.mission import make_pose
    from cslam_tpu_torch.visual_mission import SquareWorld
    world = SquareWorld()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pairs):
        x, y, w = rng.uniform(-2, 2), rng.uniform(-0.3, 0.3), \
            rng.uniform(-0.1, 0.1)
        p0 = make_pose(x, y, w)
        p1 = make_pose(x + rng.uniform(-0.2, 0.2), y + rng.uniform(-0.1, 0.1),
                       w + rng.uniform(-0.05, 0.05))
        out.append(((*world.render(p0, rng), p0), (*world.render(p1, rng),
                                                   p1)))
    return out


@contextlib.contextmanager
def lightglue_in_tf32():
    """LightGlue's fp32 products in TF32, for the control run only: the
    port refuses TF32 (device.require_full_fp32), so that check is lifted
    for the duration and both are restored after."""
    from cslam_tpu_torch.models import lightglue
    saved = lightglue.require_full_fp32
    lightglue.require_full_fp32 = lambda device=None: None
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        lightglue.require_full_fp32 = saved


def check_visual_on_card(device):
    """SuperPoint (f32, bf16) on 8 keyframes, then LightGlue (f32), 3D-3D
    RANSAC and PnP RANSAC on 8 pairs, on `device` against the CPU on the
    same inputs; raises on any gate, returns the largest differences.

    Each bound is also read against a control at the next lower
    precision, which must exceed it: SuperPoint's two f32 1x1 heads
    computed in bf16, LightGlue's products in TF32. RANSAC's hypothesis
    samples are drawn on the host from the same mask for both devices
    (ops/matching2d.draw_samples), so they are identical by
    construction; the inlier sets and poses are what the card
    computes."""
    ref = "cpu"
    from cslam_tpu_torch.frontend.rgbd_handler import RGBDHandler
    from cslam_tpu_torch.models import zoo
    from cslam_tpu_torch.models.lightglue import LightGlue, mutual_matches
    from cslam_tpu_torch.models.superpoint import SuperPoint, \
        SuperPointNet, _cell_scores_to_heatmap, extract
    from cslam_tpu_torch.ops import matching2d, pnp
    from cslam_tpu_torch.visual_mission import INTR

    pairs = visual_frames(VISUAL_CHECK_PAIRS, seed=SEED + 9)
    sp_npz = zoo.shipped_checkpoint("superpoint_synth.npz")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        desc_tol, heat_tol, min_cos = SP_TOL[dtype]
        nets = {d: SuperPoint(sp_npz, 128, device=d) for d in (device, ref)}
        if dtype == torch.float32:  # same weights, convs in f32
            for d, sp in nets.items():
                net = SuperPointNet(dtype=torch.float32)
                net.load_state_dict(sp.model.state_dict())
                sp.model = net.eval().to(d)
        worst = {"heat": 0.0, "desc": 0.0, "min_cos": 1.0, "overlap": 1.0}
        if dtype == torch.bfloat16:
            worst["heat_heads_in_bf16_control"] = 0.0
        for (img, _, _), _ in pairs:
            got = {}
            for d, sp in nets.items():
                x = sp.image_tensor(img)
                with torch.no_grad():
                    det, desc = sp.model(x[None, :, :, None])
                got[d] = ([_cell_scores_to_heatmap(det)[0].cpu().numpy(),
                           desc[0].cpu().numpy()] +
                          [a.cpu().numpy() for a in extract(sp.model, x, 128)])
            (h_c, d_c, xy_c, _, _, m_c), (h_r, d_r, xy_r, _, _, m_r) = \
                got[device], got[ref]
            worst["heat"] = max(worst["heat"], float(np.abs(h_c - h_r).max()))
            worst["desc"] = max(worst["desc"], float(np.abs(d_c - d_r).max()))
            worst["min_cos"] = min(worst["min_cos"], float(
                np.min(np.sum(d_c * d_r, axis=-1))))
            ref_set = {tuple(p) for p in xy_r[m_r > 0]}
            worst["overlap"] = min(worst["overlap"], sum(
                tuple(p) in ref_set for p in xy_c[m_c > 0]) / max(
                len(ref_set), int(m_c.sum()), 1))
            if dtype == torch.float32 and not (
                    np.array_equal(xy_c, xy_r) and np.array_equal(m_c, m_r)):
                raise AssertionError("SuperPoint f32: other keypoints on "
                                     "the card")
            if dtype == torch.bfloat16:
                net = nets[device].model
                net.convPb.compute_dtype = net.convDb.compute_dtype = dtype
                try:
                    with torch.no_grad():
                        det, _ = net(nets[device].image_tensor(img)[
                            None, :, :, None])
                finally:
                    net.convPb.compute_dtype = torch.float32
                    net.convDb.compute_dtype = torch.float32
                worst["heat_heads_in_bf16_control"] = max(
                    worst["heat_heads_in_bf16_control"], float(np.abs(
                        _cell_scores_to_heatmap(det.float())[0].cpu()
                        .numpy() - h_r).max()))
        if not (worst["heat"] <= heat_tol and worst["desc"] <= desc_tol
                and (min_cos is None or worst["min_cos"] >= min_cos)):
            raise AssertionError(f"SuperPoint {dtype} card vs CPU: {worst}")
        if worst.get("heat_heads_in_bf16_control", np.inf) <= heat_tol:
            raise AssertionError(f"SuperPoint bf16: the bf16-head control "
                                 f"is within the bound: {worst}")
        out[f"superpoint_{str(dtype)[6:]}"] = worst

    # LightGlue, RANSAC and PnP on 8 pairs; features from a CPU handler
    # (the mission's bf16 SuperPoint), so both sides see the same inputs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    h = RGBDHandler({"robot_id": 0, "max_nb_robots": 1,
                     "frontend.features": "learned"},
                    InProcessBus(InProcessRouter(), 0), ManualClock(),
                    max_keypoints=128, device=ref)
    kfs = []
    for a, b in pairs:
        kfs.append([h.compute_local_descriptors(img, depth, INTR)
                    for img, depth, _ in (a, b)])
    lg = {d: LightGlue(zoo.shipped_checkpoint("lightglue_synth.npz"),
                       num_layers=3, device=d) for d in (device, ref)}
    worst = {"scores": 0.0, "scores_tf32_control": 0.0,
             "scores_tf32_control_over_rel_tol": 0.0, "ransac_pose": 0.0,
             "pnp_pose": 0.0}
    n_success = {"ransac": 0, "pnp": 0}
    thr = 5.0 / INTR.fx
    for (xy0, d0, p0, m0, f0), (xy1, d1, p1, m1, f1) in kfs:
        sc = {}
        args = (d0, xy0, m0, d1, xy1, m1)
        for d, model in lg.items():
            s = model.scores(*args, size=(160, 120))
            idx, val = mutual_matches(s, torch.from_numpy(m0).to(d), 0.1)
            sc[d] = (s.cpu().numpy(), idx.cpu().numpy(), val.cpu().numpy())
        with lightglue_in_tf32():
            s_x = lg[device].scores(*args, size=(160, 120)).cpu().numpy()
        (s_c, i_c, v_c), (s_r, i_r, v_r) = sc[device], sc[ref]
        valid = (m0[:, None] > 0) & (m1[None, :] > 0)
        if not (np.all(np.isneginf(s_c[~valid])) and
                np.array_equal(v_c, v_r) and
                np.array_equal(i_c[v_r], i_r[v_r])):
            raise AssertionError("LightGlue: other matches on the card")
        worst["scores"] = max(worst["scores"], float(
            np.abs(s_c[valid] - s_r[valid]).max()))
        diff_x = np.abs(s_x[valid] - s_r[valid])
        worst["scores_tf32_control"] = max(worst["scores_tf32_control"],
                                           float(diff_x.max()))
        worst["scores_tf32_control_over_rel_tol"] = max(
            worst["scores_tf32_control_over_rel_tol"], float((diff_x / (
                SCORE_TOL + SCORE_REL_TOL * np.abs(s_r[valid]))).max()))
        v = v_r.astype(np.float32) * m0
        rays = pnp.normalize_keypoints(xy1, (INTR.fx, INTR.fy, INTR.cx,
                                             INTR.cy))[i_r]
        for name, fn, fargs in (
                ("ransac", matching2d.ransac_rigid3d, (p0, p1[i_r], v)),
                ("pnp", pnp.ransac_pnp, (p0, rays, v))):
            kw = {"inlier_threshold": thr} if name == "pnp" else {}
            res = {}
            for d in (device, ref):
                ts = [torch.from_numpy(np.ascontiguousarray(a)).to(d)
                      for a in fargs]
                res[d] = [x.cpu().numpy() for x in fn(*ts, **kw)]
            r_c, r_r = res[device], res[ref]
            if not (np.array_equal(r_c[2], r_r[2]) and
                    bool(r_c[4]) == bool(r_r[4])):
                raise AssertionError(f"{name}: other inliers on the card")
            err = max(float(np.abs(r_c[0] - r_r[0]).max()),
                      float(np.abs(r_c[1] - r_r[1]).max()))
            worst[f"{name}_pose"] = max(worst[f"{name}_pose"], err)
            n_success[name] += int(bool(r_r[4]))
    if not (worst["scores"] <= SCORE_TOL and
            worst["ransac_pose"] <= POSE_TOL
            and worst["pnp_pose"] <= POSE_TOL):
        raise AssertionError(f"card vs CPU: {worst}")
    if not (worst["scores_tf32_control"] > SCORE_TOL and
            worst["scores_tf32_control_over_rel_tol"] > 1.0):
        raise AssertionError(f"LightGlue: the TF32 control is within the "
                             f"bounds: {worst}")
    out.update(lightglue_ransac_pnp=worst, successes=n_success,
               pairs=len(kfs))
    return out


class StatsPlaceModel:
    """Global descriptors from image statistics (tests/test_visual_chain.py's
    stand-in for the place CNN): views of one scene score near 1."""

    def __init__(self):
        self.proj = np.random.default_rng(0).standard_normal(
            (4, 16)).astype(np.float32)

    def compute_embeddings_batch(self, images):
        out = []
        for img in images:
            img = img.astype(np.float32)
            stats = np.array([img.mean(), img.std(),
                              img[: img.shape[0] // 2].mean(),
                              img[:, : img.shape[1] // 2].mean()],
                             dtype=np.float32)
            d = np.tanh(stats @ self.proj)
            out.append(d / np.linalg.norm(d))
        return np.stack(out)


# the shipped-weight chain gates' settings (tests/test_trained_weights.py,
# tests/test_visual_chain.py): learned front-end, pose error bounds
# (rotation, translation) against ground truth
TRAINED_PARAMS = {
    "frontend.features": "learned",
    "frontend.lightglue_score_threshold": 0.1,
    "frontend.max_queue_size": 5,
    "frontend.keyframe_generation_ratio_threshold": 1.0,
    "frontend.pnp_min_inliers": 6,
}
TRAINED_POSE_TOL = (0.05, 0.15)


def _pose_errors(name, R, t, pose_a, pose_b):
    """Max abs error of the relative pose (R, t) of b in a against ground
    truth; raises beyond TRAINED_POSE_TOL."""
    (Ra, ta), (Rb, tb) = pose_a, pose_b
    err = (float(np.abs(R - Ra.T @ Rb).max()),
           float(np.abs(t - Ra.T @ (tb - ta)).max()))
    if not (err[0] <= TRAINED_POSE_TOL[0] and err[1] <= TRAINED_POSE_TOL[1]):
        raise AssertionError(f"{name}: pose error {err}")
    return err


def check_lightglue_quality(device):
    """tests/test_trained_weights.py:88-128 on `device`: the shipped
    LightGlue's F1 above raw mutual matching's by more than 0.05 and
    precision >= 0.85 at sigma 0.7; returns eval_matching's numbers."""
    from cslam_tpu_torch.models import zoo
    from cslam_tpu_torch.models.lightglue import LightGlue
    from cslam_tpu_torch.models.train_lightglue import eval_matching

    lg = LightGlue(zoo.shipped_checkpoint("lightglue_synth.npz"),
                   num_layers=3, device=device)
    ev = eval_matching(lg.model, np.random.default_rng(4321), n_pairs=16,
                       K=96, sigma=0.7)

    def f1(d):
        return 2 * d["precision"] * d["recall"] / max(
            d["precision"] + d["recall"], 1e-9)

    ev["lightglue_f1"], ev["raw_f1"] = f1(ev["lightglue"]), f1(ev["raw"])
    if not (ev["lightglue_f1"] > ev["raw_f1"] + 0.05 and
            ev["lightglue"]["precision"] >= 0.85):
        raise AssertionError(f"LightGlue quality gate: {ev}")
    return ev


def check_offset_revisit(device):
    """tests/test_trained_weights.py:169 on `device`: the learned chain
    (handler -> descriptor component -> detection -> verification ->
    back-end) with the shipped weights verifies a displaced revisit
    (~0.15 m, 2 deg) of keyframe 0; returns the pose errors."""
    from cslam_tpu_torch.backend.decentralized_pgo import DecentralizedPGO
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend.global_descriptor_component import \
        GlobalDescriptorComponent
    from cslam_tpu_torch.frontend.loop_closure_detection import \
        GlobalDescriptorLoopClosureDetection
    from cslam_tpu_torch.frontend.rgbd_handler import RGBDHandler
    from cslam_tpu_torch.frontend.sim import render_corner_scene
    from cslam_tpu_torch.mission import make_pose
    from cslam_tpu_torch.visual_mission import INTR

    params = dict(TRAINED_PARAMS, **{
        "robot_id": 0, "max_nb_robots": 1,
        "frontend.similarity_threshold": 0.9,
        "frontend.global_descriptor_technique": "custom",
        "frontend.nb_best_matches": 5,
        "frontend.intra_loop_min_inbetween_keyframes": 2,
        "frontend.enable_intra_robot_loop_closures": True,
        "frontend.detection_publication_max_elems_per_msg": 10,
        "frontend.enable_sparsification": True,
        "frontend.use_vertex_cover_selection": True,
        "frontend.sensor_type": "rgbd",
        "backend.max_waiting_time_sec": 60.0,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
        "evaluation.enable_simulated_rendezvous": False,
        "evaluation.rendezvous_schedule_file": ""})
    router, clock = InProcessRouter(), ManualClock()
    bus = InProcessBus(router, 0)
    model = StatsPlaceModel()
    h = RGBDHandler(params, bus, clock, max_keypoints=128, device=device)
    gdc = GlobalDescriptorComponent(params, bus, model=model, batch_size=1,
                                    device=device)
    GlobalDescriptorLoopClosureDetection(params, bus, clock,
                                         descriptor_model=model,
                                         device=device)
    backend = DecentralizedPGO(params, bus, clock, device=device)
    poses = [make_pose(0.0), make_pose(0.9, 0.25, 0.12),
             make_pose(1.8, 0.0, 0.22), make_pose(0.9, -0.25, 0.12),
             make_pose(0.12, 0.06, 0.035)]
    rng = np.random.default_rng(2)
    try:
        for pose in poses:
            img, depth = render_corner_scene(pose, INTR, rng)
            h.add_sensor_data(img, depth, INTR, pose)
            h.process_new_sensor_data()
            gdc.tick()
            router.spin_until_idle()
        loops = [f for f in backend.local_factors if f.is_loop]
    finally:
        backend.close()
        h.close()
    if not loops:
        raise AssertionError("offset revisit: no loop closure verified")
    lc = loops[0]
    return _pose_errors("offset revisit", lc.R, lc.t,
                        poses[lc.key_from[1]], poses[lc.key_to[1]])


def check_inter_robot(device):
    """tests/test_trained_weights.py:233 on `device`: robot 0's learned
    keyframe features cross the bus on a LocalDescriptorsRequest and
    robot 1 verifies them against its own displaced view; returns the
    pose errors."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend.rgbd_handler import RGBDHandler
    from cslam_tpu_torch.frontend.sim import render_corner_scene
    from cslam_tpu_torch.mission import make_pose
    from cslam_tpu_torch.visual_mission import INTR

    router = InProcessRouter()
    results = []
    router.subscribe("/cslam/inter_robot_loop_closure", results.append)
    buses = {rid: InProcessBus(router, rid) for rid in (0, 1)}
    handlers = {rid: RGBDHandler(
        dict(TRAINED_PARAMS, robot_id=rid, max_nb_robots=2), buses[rid],
        ManualClock(), max_keypoints=128, device=device) for rid in (0, 1)}
    rng = np.random.default_rng(5)
    poses = (make_pose(0.0), make_pose(0.4, -0.12, -0.05))
    try:
        for rid, pose in enumerate(poses):
            img, depth = render_corner_scene(pose, INTR, rng)
            handlers[rid].add_sensor_data(img, depth, INTR, pose)
            handlers[rid].process_new_sensor_data()
        buses[0].publish("cslam/local_descriptors_request",
                         msgs.LocalDescriptorsRequest(
                             keyframe_id=0, matches_robot_id=[1],
                             matches_keyframe_id=[0]))
        router.spin_until_idle()
    finally:
        for handler in handlers.values():
            handler.close()
    if len(results) != 1 or not results[0].success:
        raise AssertionError(f"inter-robot: not verified ({len(results)})")
    return _pose_errors("inter-robot", *results[0].pose, *poses)


def check_trained_gates(device):
    """The reference's shipped-weight gates on `device`: LightGlue's F1
    over raw matching, the offset revisit and inter-robot verification;
    raises on any, returns their numbers."""
    ev = check_lightglue_quality(device)
    return {"lightglue_f1": ev["lightglue_f1"], "raw_f1": ev["raw_f1"],
            "lightglue_precision": ev["lightglue"]["precision"],
            "pose_errors_rot_trans": {
                "offset_revisit": check_offset_revisit(device),
                "inter_robot": check_inter_robot(device)}}


def run_visual_phase(kp, card):
    """Phase 10; returns its fields, raising on any gate."""
    from cslam_tpu_torch.runtime.tracing import tracer
    from cslam_tpu_torch.visual_mission import H, W, run_visual_mission
    n_robots, n_poses = VISUAL["n_robots"], VISUAL["n_poses"]
    reset_launches(kp)
    tracer.clear()
    tracer.enable(None)  # host spans in memory
    try:
        res = run_visual_mission(n_robots, n_poses, device="cuda")
        spans = tracer.totals()
    finally:
        tracer.disable()
        tracer.clear()
    launches = dict(kp.cosine_topk_pallas.launches)
    threads = live_non_daemon_threads()

    def secs(*names):
        return sum(spans.get(n, {"seconds": 0.0})["seconds"] for n in names)

    def count(*names):
        return sum(spans.get(n, {"count": 0})["count"] for n in names)

    lg_s, ransac_s = secs("lightglue_match"), secs("ransac_3d3d",
                                                   "ransac_pnp")
    n_lg, n_ransac = count("lightglue_match"), count("ransac_3d3d",
                                                     "ransac_pnp")
    stages = dict(res["timings_s"])
    stages.update(superpoint_extraction=secs("feature_extract"),
                  descriptor=secs("descriptor_preprocess",
                                  "descriptor_forward"),
                  verification=lg_s + ransac_s)
    ate = {r: {"odometry": o, "optimized": p}
           for r, (o, p) in res["ate"].items()}
    fields = dict(
        robots=n_robots, keyframes_per_robot=n_poses,
        image=f"{H}x{W} grey", max_keypoints=128,
        keyframes=res["keyframes"], stages_s=stages,
        verifications=res["verifications"],
        ms_per_verified_pair={
            "lightglue": lg_s / max(n_lg, 1) * 1e3,
            "ransac_pnp": ransac_s / max(n_ransac, 1) * 1e3},
        lightglue_matches=n_lg, ransac_calls=n_ransac,
        host_copies=res["host_copies"],
        intra_loop_closures=len(res["intra_loop_closures"]),
        inter_loop_closures=len(res["inter_loop_closures"]),
        optimization_count=res["optimization_count"], ate=ate,
        knn_launches=launches, threads_left=threads, card=card)
    if launches["cosine_topk_f32"] <= 0:
        raise AssertionError("the visual mission never launched the kernel")
    if not res["inter_loop_closures"]:
        raise AssertionError("no inter-robot loop closure verified")
    if not ate:
        raise AssertionError("no robot received optimized estimates")
    for r, a in ate.items():
        if not a["optimized"] < a["odometry"]:
            raise AssertionError(f"robot {r}: optimized ATE {a['optimized']}"
                                 f" is not below odometry {a['odometry']}")
    if threads:
        raise AssertionError(f"non-daemon threads outlived the visual "
                             f"mission: {threads}")
    return fields


def layer_ops(model, *inputs):
    """[(operations, dtype)] of one forward: 2 x multiply-adds of every
    conv and linear layer (with the dtype it computes in), from forward
    hooks."""
    counts = []

    def hook(m, inp, out):
        dt = getattr(m, "compute_dtype", torch.float32)
        if isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] * \
                m.kernel_size[1]
            counts.append((2.0 * out.numel() * k, dt))
        else:
            counts.append((2.0 * out.numel() * m.in_features, dt))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return counts


def ops_bound_ms(ops, nbytes):
    """Least time of a forward: each layer's operations at the card's
    peak for its dtype, against its bytes over HBM bandwidth."""
    t_ops = sum(f / PEAK_FLOPS[dt] for f, dt in ops) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def time_visual_models(card):
    """Phase 11: CUDA-event ms of SuperPoint and LightGlue forwards
    against their bounds."""
    from cslam_tpu_torch.models import zoo
    from cslam_tpu_torch.models.cosplace import flax_init_
    from cslam_tpu_torch.models.lightglue import LightGlue, LightGlueNet
    from cslam_tpu_torch.models.superpoint import SuperPoint
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    sp = SuperPoint(zoo.shipped_checkpoint("superpoint_synth.npz"), 128,
                    device=dev)
    n_params = sum(p.numel() for p in sp.model.parameters())
    for h, w in ((120, 160), (480, 640)):
        x = torch.rand((1, h, w, 1), generator=gen, device=dev)
        ops = layer_ops(sp.model, x)
        # input f32, weights f32, det (65) + desc (256) f32 per 8x8 cell
        nbytes = 4 * (x.numel() + n_params + (h // 8) * (w // 8) * 321)
        bound, by = ops_bound_ms(ops, nbytes)
        ms = time_forward(lambda: sp.model(x))
        flops = sum(f for f, _ in ops)
        out[f"superpoint_{h}x{w}"] = dict(
            dtype="bfloat16 convs, f32 heads", ms=ms, flops=flops,
            bound_ms=bound, bound_by=by, tflops_per_s=flops / ms / 1e9)
    for name, layers, K, model in (
            ("lightglue_3l_k128", 3, 128,
             LightGlue(zoo.shipped_checkpoint("lightglue_synth.npz"),
                       num_layers=3, device=dev).model),
            ("lightglue_9l_k1024", 9, 1024, flax_init_(
                LightGlueNet(num_layers=9), seed=SEED).eval().to(dev))):
        d = model.dim
        desc = [torch.nn.functional.normalize(torch.randn(
            (K, d), generator=gen, device=dev), dim=-1) for _ in range(2)]
        xy = [torch.rand((K, 2), generator=gen, device=dev) * 2 - 1
              for _ in range(2)]
        m = torch.ones(K, device=dev)
        args = (desc[0], xy[0], m, desc[1], xy[1], m)
        # attention products per layer: self 2 x 4 K^2 d, cross 6 K^2 d;
        # the assignment's similarity 2 K^2 d
        ops = layer_ops(model, *args) + [
            (float((14 * layers + 2) * K * K * d), torch.float32)]
        n_params = sum(p.numel() for p in model.parameters())
        nbytes = 4 * (2 * K * (d + 3) + n_params + K * K)
        bound, by = ops_bound_ms(ops, nbytes)
        ms = time_forward(lambda: model(*args))
        flops = sum(f for f, _ in ops)
        out[name] = dict(dtype="float32", layers=layers, keypoints=K,
                         ms=ms, flops=flops, bound_ms=bound, bound_by=by,
                         tflops_per_s=flops / ms / 1e9)
    out["card"] = card
    return out


# -- the lidar phase ----------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device)


def _next_pow2(n):
    """The padded size of a registration (LidarHandler._register)."""
    return 1 << (max(n, 1) - 1).bit_length()


def lidar_phase_scans(wanted):
    """{(robot, pose): raw scan} for the wanted (robot, pose) keys, drawn
    as the lidar phase draws them: its world, its trajectories and its
    scan stream, every robot's scan in turn."""
    from cslam_tpu_torch.lidar_mission import SCAN_SEED, LidarWorld, \
        trajectories
    world = LidarWorld(*LIDAR["world"])
    true, _ = trajectories(LIDAR["n_robots"], LIDAR["n_poses"])
    rng = np.random.default_rng(SCAN_SEED)
    out = {}
    for kf in range(max(p for _, p in wanted) + 1):
        for rid in range(LIDAR["n_robots"]):
            scan = world.scan(true[rid][kf], rng)
            if (rid, kf) in wanted:
                out[rid, kf] = scan
    return out


def _ulps_from_edge(value, width):
    """Distance in f32 ulps of value from its nearest multiple of width
    (a bin edge)."""
    edge = np.float32(round(float(value) / width) * width)
    return abs(float(value) - float(edge)) / float(np.spacing(
        np.float32(max(abs(edge), 1e-30))))


def _check_sc_on_card(device, clouds):
    """Scan Contexts of the keyframe clouds on `device` against the CPU:
    identical, or at most one flipped cell per keyframe whose flipped
    points lie within one ulp of a ring or sector edge; then the same
    yaw for every pair and the same best match for every keyframe."""
    from cslam_tpu_torch.matching.scancontext_matching import \
        ScanContextMatching
    from cslam_tpu_torch.ops import scancontext as sc_ops
    out = {"flipped_cells": 0, "flipped_points": 0,
           "flip_max_ulps_from_edge": 0.0, "theta_values_differing": 0,
           "points": 0}
    scs = {}
    for key, cloud in clouds.items():
        got = {}
        for d in (device, "cpu"):
            pts = _dev(cloud, d)
            mask = torch.ones(len(cloud), device=pts.device)
            got[d] = [_np(x) for x in sc_ops.polar_bins(pts, mask)] + [
                _np(sc_ops.pointcloud_to_scancontext(pts, mask))]
        (b_c, th_c, _, sc_c), (b_r, th_r, r_r, sc_r) = got[device], \
            got["cpu"]
        cells = int(np.sum(sc_c != sc_r))
        if cells > 1:
            raise AssertionError(f"Scan Context {key}: {cells} cells differ")
        for i in np.nonzero(b_c != b_r)[0]:
            if b_c[i] // sc_ops.NUM_SECTOR != b_r[i] // sc_ops.NUM_SECTOR:
                ulps = _ulps_from_edge(r_r[i], sc_ops.MAX_LENGTH /
                                       sc_ops.NUM_RING)
            else:
                ulps = _ulps_from_edge(th_r[i], 360.0 / sc_ops.NUM_SECTOR)
            out["flip_max_ulps_from_edge"] = max(
                out["flip_max_ulps_from_edge"], ulps)
            out["flipped_points"] += 1
            if ulps > 1.0:
                raise AssertionError(f"Scan Context {key}: point {i} "
                                     f"changed bin {ulps} ulps from an edge")
        out["flipped_cells"] += cells
        out["theta_values_differing"] += int(np.sum(th_c != th_r))
        out["points"] += len(cloud)
        scs[key] = {device: sc_c, "cpu": sc_r}
    for a, b in LIDAR_CHECK_PAIRS:
        yaws = [int(sc_ops.scancontext_distances(
            _dev(scs[b][d], d), _dev(scs[a][d], d)[None])[1][0])
            for d in (device, "cpu")]
        if yaws[0] != yaws[1]:
            raise AssertionError(f"Scan Context yaw {a} -> {b}: {yaws}")
    best = {}
    for d in (device, "cpu"):
        db = ScanContextMatching(device=d)
        for key, sc in scs.items():
            db.add_item(sc[d], key)
        best[d] = [db.search_best(sc[d])[0] for sc in scs.values()]
    if best[device] != best["cpu"]:
        raise AssertionError(f"Scan Context best matches: {best}")
    return out


def _check_fpfh_on_card(device, clouds):
    """FPFH at the registration's padded size on `device` against the
    CPU. The rows whose 16 neighbours agree (as a set) must be >= 99.5%.
    An SPFH histogram differs where an angle lies within rounding of a
    bin edge: each such change must come from values within 1e-4 of a
    bin apart. The FPFH of a row (1e-4) is compared where its
    neighbours, its neighbours' neighbours and their histograms agree."""
    from cslam_tpu_torch.frontend.lidar_handler import _pad_cloud
    from cslam_tpu_torch.ops import fpfh as fpfh_ops
    out = {"rows": 0, "rows_neighbours_agree": 0, "rows_compared": 0,
           "max_abs_err": 0.0, "spfh_rows_differing": 0,
           "bin_change_max_scaled_diff": 0.0}
    for key, cloud in clouds.items():
        padded, mask = _pad_cloud(cloud, _next_pow2(len(cloud)))
        got = {}
        for d in (device, "cpu"):
            pts, m = _dev(padded, d), _dev(mask, d)
            idx, d2 = fpfh_ops.knn_indices(pts, m, 16)
            normals = fpfh_ops.normals_from(pts, idx, d2)
            valid = torch.isfinite(d2) & (m[:, None] > 0)
            angles, _ = fpfh_ops.darboux_angles(pts, normals, idx)
            got[d] = (_np(idx), _np(fpfh_ops.spfh(angles, valid)),
                      [_np(fpfh_ops.scaled_angles(a, lo, hi)) for a, (lo, hi)
                       in zip(angles, fpfh_ops.ANGLE_RANGES)],
                      _np(valid), _np(fpfh_ops.fpfh(pts, m)))
        (i_c, h_c, s_c, _, f_c), (i_r, h_r, s_r, v_r, f_r) = \
            got[device], got["cpu"]
        n = len(cloud)
        i_c, h_c, f_c, i_r, h_r, v_r, f_r = (
            x[:n] for x in (i_c, h_c, f_c, i_r, h_r, v_r, f_r))
        agree = np.all(np.sort(i_c, 1) == np.sort(i_r, 1), axis=1)
        clean = agree & np.all(h_c == h_r, axis=1)
        compared = clean & np.all(clean[np.minimum(i_r, n - 1)], axis=1)
        out["rows"] += n
        out["rows_neighbours_agree"] += int(agree.sum())
        out["rows_compared"] += int(compared.sum())
        out["spfh_rows_differing"] += int((agree & ~clean).sum())
        if compared.any():
            out["max_abs_err"] = max(out["max_abs_err"], float(
                np.abs(f_c[compared] - f_r[compared]).max()))
        same_pair = v_r & (i_c == i_r)
        for a, b in zip(s_c, s_r):
            a, b = a[:n][same_pair], b[:n][same_pair]
            changed = np.clip(a.astype(np.int32), 0, fpfh_ops.N_BINS - 1) \
                != np.clip(b.astype(np.int32), 0, fpfh_ops.N_BINS - 1)
            if changed.any():
                out["bin_change_max_scaled_diff"] = max(
                    out["bin_change_max_scaled_diff"],
                    float(np.abs(a - b)[changed].max()))
    out["share_neighbours_agree"] = out["rows_neighbours_agree"] / out["rows"]
    if out["share_neighbours_agree"] < LIDAR_FPFH_ROWS:
        raise AssertionError(f"FPFH neighbourhoods: {out}")
    if out["max_abs_err"] > LIDAR_FPFH_TOL or \
            out["bin_change_max_scaled_diff"] > LIDAR_FPFH_TOL:
        raise AssertionError(f"FPFH card vs CPU: {out}")
    return out


def check_lidar_on_card(device):
    """The lidar phase's keyframes on `device` against the CPU, on
    LIDAR_CHECK_PAIRS: the voxel grid at the handler's capacity
    (identical keep masks, centroids within 1e-6, bitwise equal across
    two runs on `device`), Scan Contexts (_check_sc_on_card), FPFH
    (_check_fpfh_on_card), then gnc_icp from the CPU's Scan Context yaw
    seed, and the closure the handler publishes through its entry points
    (an intra-robot match request, or a cloud sent by another robot):
    the same success flag, poses within 1e-3. RANSAC's samples are
    drawn on the host from each device's correspondence mask
    (ops/matching2d.draw_samples): equal masks give equal samples by
    construction. Raises on any gate; returns the readings."""
    from cslam_tpu_torch.frontend.lidar_handler import _pad_cloud
    from cslam_tpu_torch.lidar_mission import make_params
    from cslam_tpu_torch.ops import registration, scancontext as sc_ops
    scans = lidar_phase_scans({k for pair in LIDAR_CHECK_PAIRS
                               for k in pair})
    params = make_params(0, 1)
    voxel = params["frontend.voxel_size"]
    out = {"pairs": len(LIDAR_CHECK_PAIRS), "voxel_centroid_err": 0.0,
           "raw_points": sorted(len(s) for s in scans.values()),
           "bounds": {"voxel_centroid_err": LIDAR_CENTROID_TOL,
                      "sc_cells_per_keyframe": 1, "sc_flip_ulps": 1.0,
                      "fpfh_max_abs_err": LIDAR_FPFH_TOL,
                      "fpfh_share_neighbours_agree": LIDAR_FPFH_ROWS,
                      "pose_err": LIDAR_POSE_TOL}}
    clouds = {}
    for key, scan in scans.items():
        padded, mask = _pad_cloud(scan, LIDAR_CAPACITY)
        (c1, k1), (c2, k2), (c_r, k_r) = (
            [_np(x) for x in registration.voxel_downsample(
                _dev(padded, d), _dev(mask, d), voxel)]
            for d in (device, device, "cpu"))
        if not (np.array_equal(c1, c2) and np.array_equal(k1, k2)):
            raise AssertionError(f"voxel grid {key}: two runs differ")
        if not np.array_equal(k1, k_r):
            raise AssertionError(f"voxel grid {key}: other voxels kept")
        out["voxel_centroid_err"] = max(out["voxel_centroid_err"], float(
            np.abs(c1 - c_r)[k_r > 0].max()))
        clouds[key] = c_r[k_r > 0]
    if out["voxel_centroid_err"] > LIDAR_CENTROID_TOL:
        raise AssertionError(f"voxel centroids card vs CPU: {out}")
    out["scancontext"] = _check_sc_on_card(device, clouds)
    out["fpfh"] = _check_fpfh_on_card(device, clouds)

    worst = {"gnc_icp": 0.0, "closure": 0.0}
    successes = {"gnc_icp": 0, "intra_success": 0, "inter_success": 0}
    for a, b in LIDAR_CHECK_PAIRS:
        cap = _next_pow2(max(len(clouds[a]), len(clouds[b])))
        padded = [x for cloud in (clouds[a], clouds[b])
                  for x in _pad_cloud(cloud, cap)]
        cpu = [_dev(x, "cpu") for x in padded]
        _, yaws = sc_ops.scancontext_distances(
            sc_ops.pointcloud_to_scancontext(cpu[2], cpu[3]),
            sc_ops.pointcloud_to_scancontext(cpu[0], cpu[1])[None])
        yaw = np.float32(-int(yaws[0]) * (2.0 * np.pi / 60.0))
        icp, closure = {}, {}
        for d in (device, "cpu"):
            R0 = registration.yaw_rotation(torch.tensor(yaw, device=d))
            icp[d] = registration.gnc_icp(
                *(_dev(x, d) for x in padded), R0, torch.zeros(3, device=d),
                max_corr_dist=2.0 * voxel,
                max_iters=params.get("frontend.icp_max_iters", 12),
                iters_per_level=params.get(
                    "frontend.icp_max_iters_per_level", 5))
            closure[d] = _verify_through_handler(d, clouds, a, b)
        r_c, r_r = icp[device], icp["cpu"]
        if bool(r_c.success) != bool(r_r.success):
            raise AssertionError(f"gnc_icp {a} -> {b}: success differs")
        worst["gnc_icp"] = max(worst["gnc_icp"],
                               float(np.abs(_np(r_c.R) - _np(r_r.R)).max()),
                               float(np.abs(_np(r_c.t) - _np(r_r.t)).max()))
        successes["gnc_icp"] += int(bool(r_r.success))
        m_c, m_r = closure[device], closure["cpu"]
        if bool(m_c.success) != bool(m_r.success):
            raise AssertionError(f"closure {a} -> {b}: success differs")
        worst["closure"] = max(worst["closure"], *(
            float(np.abs(x - y).max()) for x, y in zip(m_c.pose, m_r.pose)))
        kind = "intra" if a[0] == b[0] else "inter"
        successes[f"{kind}_success"] += int(bool(m_c.success))
    if max(worst.values()) > LIDAR_POSE_TOL:
        raise AssertionError(f"ICP card vs CPU: {worst}")
    out.update(pose_err=worst, closures=successes)
    return out


def _verify_through_handler(device, clouds, a, b):
    """The closure a LidarHandler on `device` publishes for keyframe
    clouds a and b ((robot, pose) keys): an intra-robot match request
    when one robot holds both, else robot a's cloud sent to robot b.
    Both run _register(src=a, dst=b)."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend.lidar_handler import LidarHandler
    from cslam_tpu_torch.lidar_mission import make_params
    router = InProcessRouter()
    bus = InProcessBus(router, b[0])
    handler = LidarHandler(make_params(b[0], LIDAR["n_robots"]), bus,
                           ManualClock(), device=device)
    published = []
    router.subscribe("/cslam/inter_robot_loop_closure", published.append)
    bus.subscribe("cslam/intra_robot_loop_closure", published.append)
    handler.local_keyframes[b[1]] = clouds[b]
    if a[0] == b[0]:
        handler.local_keyframes[a[1]] = clouds[a]
        bus.publish("cslam/local_keyframe_match", msgs.LocalKeyframeMatch(
            keyframe0_id=a[1], keyframe1_id=b[1]))
    else:
        handler.receive_local_descriptors(msgs.LocalPointCloudDescriptors(
            robot_id=a[0], keyframe_id=a[1], matches_robot_id=[b[0]],
            matches_keyframe_id=[b[1]], points=clouds[a]))
    router.spin_until_idle()
    if len(published) != 1:
        raise AssertionError(f"{a} -> {b}: {len(published)} closures")
    return published[0]


def run_lidar_phase(kp, card):
    """Phase 12's mission; returns its fields (check_lidar_phase holds
    them to the phase's gates)."""
    from cslam_tpu_torch.lidar_mission import run_lidar_mission
    from cslam_tpu_torch.runtime.tracing import tracer
    reset_launches(kp)
    tracer.clear()
    tracer.enable(None)  # host spans in memory
    try:
        res = run_lidar_mission(LIDAR["n_robots"], LIDAR["n_poses"],
                                world=LIDAR["world"], device="cuda")
        spans = tracer.totals()
    finally:
        tracer.disable()
        tracer.clear()
    launches = dict(kp.cosine_topk_pallas.launches)
    threads = live_non_daemon_threads()

    def secs(name):
        return spans.get(name, {"seconds": 0.0})["seconds"]

    n_reg = res["verifications"]
    stages = dict(res["timings_s"])
    for name in ("voxel_downsample", "scancontext_embedding"):
        stages[name] = secs(name)
    verify = ("scancontext", "fpfh", "ransac_3d3d", "gnc_icp")
    stages["verification"] = sum(secs(n) for n in verify)

    def spread(xs):
        return [int(min(xs)), float(np.median(xs)), int(max(xs))]

    ate = {r: {"odometry": o, "optimized": p}
           for r, (o, p) in res["ate"].items()}
    fields = dict(
        robots=LIDAR["n_robots"], poses_per_robot=LIDAR["n_poses"],
        world=dict(zip(("n_clusters", "extent", "sensor_range"),
                       LIDAR["world"])),
        capacity=LIDAR_CAPACITY, keyframes=res["keyframes"],
        raw_scan_points_min_median_max=spread(res["scan_sizes"]),
        cloud_points_min_median_max=spread(res["cloud_sizes"]),
        register_caps=res["register_caps"], registrations=n_reg,
        outcomes=res["outcomes"],
        intra_loop_closures=len(res["intra_loop_closures"]),
        intra_loop_closures_expected=(
            "0: the detector proposes none, as the reference's: a Scan "
            "Context search returns only its best match, the query "
            "keyframe itself, which match_local_loop_closures drops; "
            "check_lidar_on_card drives the handler's intra-robot "
            "verification"),
        inter_loop_closures=len(res["inter_loop_closures"]),
        stages_s=stages,
        ms_per_registration={n: secs(n) / max(n_reg, 1) * 1e3
                             for n in verify},
        icp_iterations_per_registration=res["icp_iterations"] / max(n_reg, 1),
        # gnc_icp reads each iteration's step size back: one sync each
        icp_host_syncs=res["icp_iterations"],
        optimization_count=res["optimization_count"], ate=ate,
        knn_launches=launches,
        knn_launches_expected="0: lidar robots match Scan Contexts "
                              "(ScanContextMatching), not the cosine top-k",
        threads_left=threads, card=card)
    return fields


def check_lidar_phase(fields):
    """Phase 12's gates; raises on the first that fails."""
    caps, n_reg = fields["register_caps"], fields["registrations"]
    if not n_reg or set(caps) != {LIDAR_CAPACITY}:
        raise AssertionError(f"registrations not all at the {LIDAR_CAPACITY}"
                             f" cap: {caps}")
    if not fields["inter_loop_closures"]:
        raise AssertionError("the lidar mission verified no inter-robot "
                             "loop closure")
    closures = fields["card_vs_cpu"]["closures"]
    if not (closures["intra_success"] and closures["inter_success"]):
        raise AssertionError(f"the handler verified no intra- or no "
                             f"inter-robot closure on the card: {closures}")
    ate = fields["ate"]
    if sorted(ate) != list(range(LIDAR["n_robots"])):
        raise AssertionError(f"robots with optimized estimates: {sorted(ate)}")
    for r, a in ate.items():
        if not a["optimized"] < a["odometry"]:
            raise AssertionError(f"robot {r}: optimized ATE {a['optimized']}"
                                 f" is not below odometry {a['odometry']}")
    if any(fields["knn_launches"].values()):
        raise AssertionError(f"the lidar mission launched the cosine top-k: "
                             f"{fields['knn_launches']}")
    if fields["threads_left"]:
        raise AssertionError(f"non-daemon threads outlived the lidar "
                             f"mission: {fields['threads_left']}")


def device_busy_ms(fn):
    """Device ms of everything one call of fn runs on the card (kernels
    and copies, from torch.profiler's CUDA activity); None when the
    profiler records none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 if total else None


def time_lidar_ops(card):
    """CUDA-event ms of one voxel_downsample, fpfh, nearest_neighbors
    and gnc_icp at N = 8192 on a pair of the phase's scans, each against
    its bound: the larger of its operations over the f32 peak (8 per
    point pair of a squared-distance matrix: 6 in the GEMM, the norms'
    sum and the addend; selections and the per-point work are not
    counted) and its bytes (inputs read once, outputs written once) over
    HBM bandwidth; then the device time of one call (device_busy_ms) and
    its share of the CUDA-event time: the rest is the card waiting on
    the host's launches and syncs."""
    from cslam_tpu_torch.frontend.lidar_handler import _pad_cloud
    from cslam_tpu_torch.lidar_mission import make_params
    from cslam_tpu_torch.ops import fpfh as fpfh_ops, registration
    dev = torch.device("cuda")
    n = LIDAR_CAPACITY
    a, b = LIDAR_CHECK_PAIRS[0]
    scans = lidar_phase_scans({a, b})
    voxel = make_params(0, 1)["frontend.voxel_size"]
    raw, raw_m = (_dev(x, dev) for x in _pad_cloud(scans[a], n))
    clouds = []
    for key in (a, b):
        c, k = registration.voxel_downsample(
            *(_dev(x, dev) for x in _pad_cloud(scans[key], n)), voxel)
        clouds += [_dev(x, dev) for x in _pad_cloud(
            _np(c)[_np(k) > 0], n)]
    src, src_m, dst, dst_m = clouds
    R0, t0 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    icp = registration.gnc_icp(src, src_m, dst, dst_m, R0, t0,
                               max_corr_dist=2.0 * voxel)
    nn_passes = icp.iterations + 1
    pair_ops = 8.0 * n * n

    def row(fn, ops, nbytes, iters):
        ms = cuda_ms(fn, iters)
        busy = device_busy_ms(fn)
        t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(ms=ms, bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    ops=ops, bytes=nbytes, device_busy_ms=busy,
                    busy_share=None if busy is None else busy / ms)

    out = {
        "voxel_downsample": row(
            lambda: registration.voxel_downsample(raw, raw_m, voxel),
            0.0, n * 16 * 2, 20),
        "fpfh": row(lambda: fpfh_ops.fpfh(src, src_m), pair_ops,
                    n * 16 + n * 33 * 4, 5),
        "nearest_neighbors": row(
            lambda: registration.nearest_neighbors(src, src_m, dst, dst_m),
            pair_ops, 2 * n * 16 + n * 12, 20),
        "gnc_icp": row(
            lambda: registration.gnc_icp(src, src_m, dst, dst_m, R0, t0,
                                         max_corr_dist=2.0 * voxel),
            nn_passes * pair_ops, 2 * n * 16 + 4 * 48, 3),
    }
    out["gnc_icp"].update(iterations=icp.iterations,
                          host_syncs=icp.iterations)
    out["points"] = n
    out["card"] = card
    return out

def make_sphere_graph(n, ring, meas_noise, seed):
    """benchmarks/pgo_sphere_bench.py's make_sphere_graph on the port
    (that file imports JAX): a spiral of poses over a sphere with
    odometry and inter-ring loop closures, noisy measurements, vertices
    initialized by integrating the noisy odometry. Returns the graph,
    the ground-truth translations and the odometry's."""
    from cslam_tpu_torch.backend.factor_graph import (BetweenFactor,
                                                      FactorGraph,
                                                      diag_sqrt_info)
    from cslam_tpu_torch.ops import se3

    rng = np.random.default_rng(seed)
    radius = 30.0
    ks = np.arange(n)
    theta = 2 * np.pi * (ks % ring) / ring
    phi = np.pi * (ks / n - 0.5)
    t_gt = (radius * np.stack([np.cos(phi) * np.cos(theta),
                               np.cos(phi) * np.sin(theta),
                               np.sin(phi)], axis=1)).astype(np.float32)
    w_gt = np.stack([np.zeros(n), phi * 0.3, theta + np.pi / 2],
                    axis=1).astype(np.float32)
    R_gt = se3.so3_exp(torch.from_numpy(w_gt)).numpy()

    def rel_batch(ii, jj):
        R = np.einsum("nba,nbc->nac", R_gt[ii], R_gt[jj])
        t = np.einsum("nba,nb->na", R_gt[ii], t_gt[jj] - t_gt[ii])
        return R.astype(np.float32), t.astype(np.float32)

    def noisy_batch(R, t):
        xi = rng.standard_normal((len(t), 6)).astype(np.float32) * meas_noise
        dR, dt = (x.numpy() for x in se3.se3_exp(torch.from_numpy(xi)))
        return (np.einsum("nab,nbc->nac", R, dR).astype(np.float32),
                (t + dt).astype(np.float32))

    fg = FactorGraph()
    sq = diag_sqrt_info([meas_noise] * 3 + [meas_noise * 5] * 3)
    odo_R, odo_t = noisy_batch(*rel_batch(ks[:-1], ks[1:]))
    for k in range(n - 1):
        fg.add_between(BetweenFactor((0, k), (0, k + 1), odo_R[k], odo_t[k],
                                     sq))
    loop_to = np.asarray([k for k in range(ring, n) if k % 2 == 0])
    loop_from = loop_to - ring
    lc_R, lc_t = noisy_batch(*rel_batch(loop_from, loop_to))
    for idx in range(len(loop_to)):
        fg.add_between(BetweenFactor((0, int(loop_from[idx])),
                                     (0, int(loop_to[idx])),
                                     lc_R[idx], lc_t[idx], sq, is_loop=True))
    R_est, t_est = [R_gt[0]], [t_gt[0]]
    for R, t in zip(odo_R, odo_t):
        R_est.append(R_est[-1] @ R)
        t_est.append(R_est[-2] @ t + t_est[-1])
    for k in range(n):
        fg.add_node((0, k), R_est[k], t_est[k])
    fg.set_prior((0, 0), R_gt[0], t_gt[0])
    return fg, t_gt, np.stack(t_est)


def spawn(cmd, log_path, env):
    """Start a child in its own session (so that its whole process group
    can be killed), its stdout and stderr into the file `log_path`."""
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def kill_group(proc):
    """SIGKILL the child's process group and reap the child."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)


def group_alive(proc) -> bool:
    """Whether any process of the (reaped) child's group is left."""
    proc.poll()
    try:
        os.killpg(proc.pid, 0)
    except ProcessLookupError:
        return False
    return True


def log_tail(path, n_bytes=3000):
    with contextlib.suppress(OSError):
        return Path(path).read_text(errors="replace")[-n_bytes:]
    return ""


def run_g2o_phase(card):
    """The sphere graph written with the port's write_g2o, solved by
    `python -m cslam_tpu_torch.tools.solve_g2o in.g2o -o out.g2o
    --chordal` on the card in a child process under G2O_DEADLINE_S, the
    output read back and held against the ground truth."""
    from cslam_tpu_torch.backend.g2o import read_g2o, write_g2o
    from cslam_tpu_torch.utils.evaluation import ate_rmse
    fg, t_gt, t_odom = make_sphere_graph(**SPHERE)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.g2o"), os.path.join(tmp, "out.g2o")
        log = os.path.join(tmp, "solve.log")
        write_g2o(fg, src)
        cmd = [sys.executable, "-m", "cslam_tpu_torch.tools.solve_g2o", src,
               "-o", dst, "--chordal"]
        t0 = time.perf_counter()
        proc = spawn(cmd, log, dict(os.environ))
        try:
            proc.wait(timeout=G2O_DEADLINE_S)
        except subprocess.TimeoutExpired:
            kill_group(proc)
            raise AssertionError(f"solve_g2o passed its {G2O_DEADLINE_S} s "
                                 f"deadline:\n{log_tail(log)}") from None
        process_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"solve_g2o exited {proc.returncode}:\n"
                                 f"{log_tail(log)}")
        summary = json.loads(Path(log).read_text().strip().splitlines()[-1])
        out = read_g2o(dst)
        est = np.stack([out.t[out.key_to_index[(0, k)]]
                        for k in range(SPHERE["n"])])
    return dict(summary, process_wall_s=process_s,
                ate_odometry_m=ate_rmse(t_odom, t_gt),
                ate_optimized_m=ate_rmse(est, t_gt), card=card)


def check_g2o_phase(res):
    if res["platform"] != "cuda":
        raise AssertionError(f"solve_g2o ran on {res['platform']}")
    if res["poses"] != SPHERE["n"]:
        raise AssertionError(f"solve_g2o read {res['poses']} poses")
    if not res["final_cost"] < res["initial_cost"]:
        raise AssertionError(f"final cost {res['final_cost']} is not below "
                             f"the initial {res['initial_cost']}")
    if not res["ate_optimized_m"] < SPHERE_ATE_SHARE * res["ate_odometry_m"]:
        raise AssertionError(f"sphere ATE {res['ate_optimized_m']} is not "
                             f"below {SPHERE_ATE_SHARE} x the odometry's "
                             f"{res['ate_odometry_m']}")


def checkpoint_keyframes(manifest) -> int:
    """The latest own keyframe in a robot's checkpoint, -1 when there is
    none yet (or it is being swapped in)."""
    try:
        with open(manifest) as f:
            key = json.load(f)["latest_local_key"]
    except (OSError, ValueError):
        return -1
    return -1 if key is None else key[1]


def run_launch_phase(card):
    """Four launcher robot processes on the card over the TCP bus (LAUNCH),
    robot 1 killed with SIGKILL once its checkpoint holds
    LAUNCH_KILL_AT_KF keyframes and restarted with --resume for the
    rest of the mission less LAUNCH_END_MARGIN_S. Each child
    has a hard deadline; on expiry every child's group is killed and the
    phase fails with the tails of all robots' logs. Returns each robot's
    metrics (the launcher's --json-out) and the phase's events."""
    from cslam_tpu_torch.runtime import native
    for src in (native.BUS_SOURCE, native.LOGGER_SOURCE, native.SOURCE):
        native.build(src)  # once here, not in four children at once
    tmp = tempfile.mkdtemp(prefix="launch_phase_")
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def cmd(rid, duration, resume=False):
        c = [sys.executable, "-u", "-m", "cslam_tpu_torch.launch",
             "--robot-id", str(rid), "--robots", str(LAUNCH["robots"]),
             "--device", LAUNCH["device"], "--sim",
             "--sim-poses", str(LAUNCH["sim_poses"]),
             "--sim-kf-period", str(LAUNCH["sim_kf_period"]),
             "--duration", str(duration),
             "--base-port", str(LAUNCH["base_port"]),
             "--json-out", os.path.join(tmp, "metrics"),
             "--checkpoint-dir", os.path.join(tmp, "ckpt"),
             "--checkpoint-period", str(LAUNCH["checkpoint_period"]),
             "--log-folder", os.path.join(tmp, "logs"), "--pgo-chordal"]
        return c + ["--resume"] if resume else c

    logs = {rid: os.path.join(tmp, f"robot{rid}.log")
            for rid in range(LAUNCH["robots"])}
    procs, deadlines = {}, {}

    def start(rid, duration, resume=False, log=None):
        procs[rid] = spawn(cmd(rid, duration, resume), log or logs[rid], env)
        deadlines[rid] = time.monotonic() + duration + LAUNCH_STARTUP_S

    def fail(why):
        for p in procs.values():
            kill_group(p)
        tails = "\n".join(f"--- robot {r} ({path}):\n{log_tail(path)}"
                          for r, path in logs.items())
        raise AssertionError(f"launch phase: {why}\n{tails}")

    t0 = time.monotonic()
    events = {"loop_start_s": {}, "exit_s": {}}
    manifests = {rid: os.path.join(tmp, "ckpt", f"robot{rid}",
                                   "manifest.json")
                 for rid in range(LAUNCH["robots"])}
    peers = [rid for rid in range(LAUNCH["robots"]) if rid != 1]
    try:
        for rid in range(LAUNCH["robots"]):
            start(rid, LAUNCH["duration"])
        while checkpoint_keyframes(manifests[1]) < LAUNCH_KILL_AT_KF or \
                len(events["loop_start_s"]) < LAUNCH["robots"]:
            for rid, p in procs.items():
                if rid not in events["loop_start_s"] and \
                        os.path.exists(manifests[rid]):
                    events["loop_start_s"][rid] = time.monotonic() - t0
                if p.poll() is not None:
                    fail(f"robot {rid} exited {p.returncode} before the "
                         f"crash")
                if time.monotonic() > deadlines[rid]:
                    fail(f"robot {rid} passed its deadline before the "
                         f"crash (robot 1's checkpoint must reach "
                         f"{LAUNCH_KILL_AT_KF} keyframes)")
            time.sleep(0.1)
        events["killed_at_s"] = time.monotonic() - t0
        events["checkpoint_keyframes_at_kill"] = checkpoint_keyframes(
            manifests[1])
        kill_group(procs[1])
        events["killed_returncode"] = procs[1].returncode
        logs["1_killed"] = logs[1]
        logs[1] = os.path.join(tmp, "robot1_resumed.log")
        peers_end = min(events["loop_start_s"][r] for r in peers) + \
            LAUNCH["duration"]
        events["resume_duration_s"] = round(
            peers_end - (time.monotonic() - t0) - LAUNCH_END_MARGIN_S, 1)
        start(1, events["resume_duration_s"], resume=True)
        events["resumed_at_s"] = time.monotonic() - t0
        while len(events["exit_s"]) < LAUNCH["robots"]:
            if "resumed_loop_start_s" not in events and \
                    "resumed from checkpoint" in log_tail(logs[1], 100000):
                events["resumed_loop_start_s"] = time.monotonic() - t0
            for rid, p in procs.items():
                if rid not in events["exit_s"] and p.poll() is not None:
                    events["exit_s"][rid] = time.monotonic() - t0
                if p.poll() is None and time.monotonic() > deadlines[rid]:
                    fail(f"robot {rid} passed its deadline")
            time.sleep(0.1)
        events["mission_s"] = time.monotonic() - t0
        events["robot1_exit_before_peers_s"] = \
            min(events["exit_s"][r] for r in peers) - events["exit_s"][1]
        for rid, p in procs.items():
            if p.returncode != 0:
                fail(f"robot {rid} exited {p.returncode}")
            if f"[r{rid}] done" not in log_tail(logs[rid], 100000):
                fail(f"robot {rid} printed no done line")
        if "resumed from checkpoint" not in log_tail(logs[1], 100000):
            fail("robot 1 did not resume from its checkpoint")
        robots = {}
        for rid in range(LAUNCH["robots"]):
            with open(os.path.join(tmp, "metrics", f"robot{rid}.json")) as f:
                robots[rid] = json.load(f)
        csvs = {rid: os.path.exists(os.path.join(tmp, "logs", f"robot{rid}",
                                                 "metrics.csv"))
                for rid in range(LAUNCH["robots"])}
    finally:
        for p in procs.values():
            if p.poll() is None:
                kill_group(p)
        left = [rid for rid, p in procs.items() if group_alive(p)]
        shutil.rmtree(tmp, ignore_errors=True)
    return {"robots": robots, "events": events, "logger_csvs": csvs,
            "children_left": left, "card": card}


def launch_summary(res):
    """Per robot: keyframes, closures, optimizations, comm bytes, kernel
    launches, detection and optimization tick latencies, ATE."""
    out = {}
    for rid, m in res["robots"].items():
        ticks = m["tick_latency"]
        out[rid] = {
            "device": m["device"], "keyframes": m["keyframes"],
            "verified_loop_closures": m["verified_loop_closures"],
            "optimizations": m["optimizations"],
            "comm_tx_bytes": m["comm_tx_bytes"],
            "comm_rx_bytes": m["comm_rx_bytes"],
            "knn_launches": m["knn_launches"],
            "tick_ms": {k: ticks[k] for k in ("detection", "opt_start",
                                              "opt_loop")},
            "ate_odometry_m": m["ate_odometry_m"],
            "ate_optimized_m": m["ate_optimized_m"],
            "resumed_from_keyframe": m["resumed_from_keyframe"],
            "verified_loop_closures_at_resume":
                m["verified_loop_closures_at_resume"],
            "first_loop_closure_s": m["first_loop_closure_s"],
            "optimized_estimates": m["optimized_estimates"],
            "first_optimization_s": m["first_optimization_s"],
            "optimized_own_keyframes": m["optimized_own_keyframes"],
            # (wall s, factors, end s from the loop's start, robots)
            "solves": [(round(w["wall_s"], 3), w["n_factors"],
                        round(w["end_s"], 1), w["robots"])
                       for w in m["optimization_walls"]],
            "waiting_timeouts_s": [round(t, 1)
                                   for t in m["waiting_timeouts_s"]],
            "slow_detection_ticks": m["slow_detection_ticks"]}
    return out


def check_launch_phase(res):
    for rid, m in res["robots"].items():
        if m["device"] != "cuda:0":
            raise AssertionError(f"robot {rid} ran on {m['device']}")
        if not sum(m["knn_launches"].values()) > 0:
            raise AssertionError(f"robot {rid} never launched the kernel")
        if not m["verified_loop_closures"] > 0:
            raise AssertionError(f"robot {rid} verified no loop closure")
        if m["optimized_own_keyframes"] != m["keyframes"]:
            raise AssertionError(f"robot {rid}: its adopted estimate holds "
                                 f"{m['optimized_own_keyframes']} of its "
                                 f"{m['keyframes']} keyframes (events "
                                 f"{res['events']}; robots "
                                 f"{launch_summary(res)})")
        if m["ate_optimized_m"] is None or \
                not m["ate_optimized_m"] < m["ate_odometry_m"]:
            raise AssertionError(f"robot {rid}: optimized ATE "
                                 f"{m['ate_optimized_m']} is not below "
                                 f"odometry {m['ate_odometry_m']} "
                                 f"(events {res['events']}; robots "
                                 f"{launch_summary(res)})")
        if not res["logger_csvs"][rid]:
            raise AssertionError(f"robot {rid} wrote no logger CSV")
    m1 = res["robots"][1]
    if not (m1["resumed_from_keyframe"] or 0) > 0:
        raise AssertionError(f"robot 1 resumed from keyframe "
                             f"{m1['resumed_from_keyframe']}")
    # liveness regained: the rest of its stream, messages from its peers
    # and closures verified with them after the resume
    if m1["keyframes"] != LAUNCH["sim_poses"] or not m1["comm_rx_bytes"] > 0:
        raise AssertionError(f"robot 1 after the resume: {m1['keyframes']} "
                             f"keyframes, rx {m1['comm_rx_bytes']} B")
    if not m1["verified_loop_closures"] > \
            (m1["verified_loop_closures_at_resume"] or 0):
        raise AssertionError("robot 1 verified no loop closure after the "
                             "resume")
    if res["children_left"]:
        raise AssertionError(f"children left alive: {res['children_left']}")


def compare_topk(idx, sims, ref_idx, ref_sims, what):
    """Sharded against single-device (indices, sims), both with missing
    slots as -inf: the same missing slots, sims within
    MULTICHIP_SEARCH_TOL, and equal indices except among rows tied
    within MULTICHIP_TIE (a mismatched row must sit in the other top-k
    with a sim that close, or tie its last slot). Returns the fields."""
    idx, sims = idx.cpu().numpy(), sims.cpu().numpy()
    ref_idx, ref_sims = ref_idx.cpu().numpy(), ref_sims.cpu().numpy()
    fin = np.isfinite(sims)
    if idx.shape != ref_idx.shape or not (fin == np.isfinite(ref_sims)).all():
        raise AssertionError(f"{what}: shapes or missing slots differ")
    err = float(np.abs(sims[fin] - ref_sims[fin]).max()) if fin.any() else 0.0
    if not err <= MULTICHIP_SEARCH_TOL:
        raise AssertionError(f"{what}: sims differ by {err}")
    ties = 0
    for b, j in zip(*np.nonzero((idx != ref_idx) & fin)):
        row = ref_idx[b] == idx[b, j]
        close = (abs(ref_sims[b][row] - sims[b, j]) <= MULTICHIP_TIE).any() \
            if row.any() else abs(ref_sims[b, -1] - sims[b, j]) <= \
            MULTICHIP_TIE
        if not close:
            raise AssertionError(f"{what}: query {b} slot {j} row "
                                 f"{idx[b, j]} vs {ref_idx[b, j]}, no tie")
        ties += 1
    return {"max_sim_err": err, "tied_index_swaps": ties}


def multichip_knn(mesh, kp, gen):
    """Stage 2: the headline database split over the mesh's rows, f32
    and bf16, and the reference test's boundary n_valid; each against
    the single-card kernel search on rank 0, made first. The kernel
    launches of the sharded searches alone, summed over the ranks, are
    counted from 0. Returns (fields, launches, per-rank launches)."""
    from cslam_tpu_torch.parallel.sharded_knn import \
        kernel_slots_to_reference, sharded_cosine_topk
    m, b, dev = MULTICHIP, MULTICHIP_BOUNDARY, mesh.device
    cases = []  # (what, data, n_valid, queries, k)
    for dtype in (torch.float32, torch.bfloat16):
        data = torch.randn((m["n_cap"], m["dim"]), generator=gen,
                           device=dev).to(dtype)
        queries = torch.randn((m["batch"], m["dim"]), generator=gen,
                              device=dev)
        cases.append((str(dtype), data, m["n_valid"], queries, m["k"]))
    data = torch.randn((b["n_cap"], b["dim"]), generator=gen, device=dev)
    q = torch.randn((b["batch"], b["dim"]), generator=gen, device=dev)
    cases += [(f"n_valid={n}", data, n, q, b["k"]) for n in b["n_valid"]]
    refs = [kernel_slots_to_reference(
        *kp.cosine_topk_pallas(d, n, qq, k), n) for _, d, n, qq, k in cases]
    torch.cuda.synchronize()
    mesh.reset_launches()
    out, placed = {}, {}
    for (what, data, n_valid, queries, k), ref in zip(cases, refs):
        if id(data) not in placed:
            torch.cuda.synchronize()
            t = time.perf_counter()
            placed[id(data)] = mesh.place_rows(data)
            torch.cuda.synchronize()
            place_s = time.perf_counter() - t
        rows = placed[id(data)]
        got = sharded_cosine_topk(mesh, rows, n_valid, queries, k)
        fields = compare_topk(*got, *ref, what)
        if what.startswith("n_valid"):
            out.setdefault("boundary", {})[what] = fields
            continue

        def search():
            return sharded_cosine_topk(mesh, rows, n_valid, queries, k)

        for _ in range(3):
            search()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(MULTICHIP_SEARCH_ITERS):
            search()
        torch.cuda.synchronize()
        fields["sharded_ms"] = (time.perf_counter() - t) * 1e3 / \
            MULTICHIP_SEARCH_ITERS
        fields["place_s"] = place_s
        out[what] = fields
    launches, per_rank = mesh.launches()
    for rows in placed.values():
        rows.free()
    return out, launches, per_rank


def multichip_descriptors(mesh):
    """Stage 1: the shipped CosPlace, weights broadcast once,
    MULTICHIP_IMAGES rendered keyframes at crop 224 split over the
    ranks, against the one-process forward on rank 0 (bf16 convs as
    shipped, and the same weights with f32 convs)."""
    from cslam_tpu_torch.models.cosplace import CosPlace, \
        GeoLocalizationNet, preprocess, to_device
    dev = mesh.device
    shipped = CosPlace({"frontend.nn_checkpoint": "shipped"},
                       device=dev).model
    pool = render_pool(MULTICHIP_IMAGES, SEED + 3)
    x = to_device(preprocess(np.stack(
        [np.broadcast_to(im[..., None], im.shape + (3,)) for im in pool]),
        224), dev)
    out = {"images": MULTICHIP_IMAGES, "crop": 224}
    for dtype in (torch.bfloat16, torch.float32):
        model = shipped if dtype == torch.bfloat16 else GeoLocalizationNet(
            64, dtype=dtype).to(dev).eval()
        if model is not shipped:
            model.load_state_dict(shipped.state_dict())
        t = time.perf_counter()
        handle = mesh.replicate_module(model, GeoLocalizationNet, 64,
                                       dtype=dtype)
        replicate_s = time.perf_counter() - t
        mesh.data_parallel(handle, x)  # warm-up (cuDNN's first calls)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = mesh.data_parallel(handle, x)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t
        mesh.free(handle)
        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = model(x)
            torch.cuda.synchronize()
            single_s = time.perf_counter() - t
        err = float((got - ref).abs().max())
        cos = float((got * ref).sum(-1).min())
        tol, min_cos = MULTICHIP_DESC_TOL[dtype]
        if tuple(got.shape) != (MULTICHIP_IMAGES, 64) or not err <= tol or \
                (min_cos is not None and not cos >= min_cos):
            raise AssertionError(f"data-parallel CosPlace {dtype}: shape "
                                 f"{tuple(got.shape)}, max abs {err}, "
                                 f"cosine {cos}")
        out[str(dtype)] = {"max_abs_err": err, "min_cosine": cos,
                           "replicate_s": replicate_s,
                           "data_parallel_s": dp_s, "single_s": single_s}
    return out


def swarm_pose_graph(world, closures):
    """The slice's pose graph: every robot's odometry chain (the slice's
    drift) and a closure measured from ground truth at each
    (r0, k0, r1, k1)."""
    from cslam_tpu_torch.frontend.sim import measure
    from cslam_tpu_torch.swarm_slice import DRIFT, build_graph
    from cslam_tpu_torch.utils.edges import EdgeInterRobot
    odom = {r: world.noisy_odometry(r, drift=DRIFT)
            for r in range(world.n_robots)}
    verified = [(EdgeInterRobot(*c, 0.0), *measure(world, *c)[:2])
                for c in closures]
    return build_graph(odom, verified)


def oracle_graph(n, n_loops, outlier_every, seed, meas_noise=0.02):
    """tests/test_pgo_oracle.py's build_graph in numpy on the port: a
    random-walk trajectory, noisy odometry as initial estimates, loop
    closures with a gross outlier every `outlier_every`-th. Returns
    (graph, planted outlier flags per loop)."""
    from cslam_tpu_torch.backend.factor_graph import BetweenFactor, \
        FactorGraph, diag_sqrt_info
    from cslam_tpu_torch.backend.pgo_oracle import se3_exp
    rng = np.random.default_rng(seed)

    def noisy(R, t):
        dR, dt = se3_exp(rng.standard_normal(6).astype(np.float32)
                         * meas_noise)
        return (R @ dR).astype(np.float32), (R @ dt + t).astype(np.float32)

    Rs, ts = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for _ in range(n - 1):
        dR, dt = se3_exp(rng.standard_normal(6).astype(np.float32) * 0.15)
        Rs.append((Rs[-1] @ dR).astype(np.float32))
        ts.append((ts[-1] + Rs[-2] @ dt).astype(np.float32))
    fg = FactorGraph()
    sq = diag_sqrt_info([0.02] * 3 + [0.05] * 3)
    Rc, tc = Rs[0], ts[0]
    fg.add_node((0, 0), Rc, tc)
    for k in range(n - 1):
        Rm, tm = noisy((Rs[k].T @ Rs[k + 1]).astype(np.float32),
                       (Rs[k].T @ (ts[k + 1] - ts[k])).astype(np.float32))
        tc = (Rc @ tm + tc).astype(np.float32)
        Rc = (Rc @ Rm).astype(np.float32)
        fg.add_node((0, k + 1), Rc, tc)
        fg.add_between(BetweenFactor((0, k), (0, k + 1), Rm, tm, sq))
    planted = []
    while len(planted) < n_loops:
        i, j = sorted(rng.integers(0, n, size=2).tolist())
        if j - i < 5:
            continue
        outlier = (len(planted) + 1) % outlier_every == 0
        if outlier:
            xi = rng.standard_normal(6).astype(np.float32)
            xi[3:] *= 6.0
            Rm, tm = (a.astype(np.float32) for a in se3_exp(xi))
        else:
            Rm, tm = noisy((Rs[i].T @ Rs[j]).astype(np.float32),
                           (Rs[i].T @ (ts[j] - ts[i])).astype(np.float32))
        fg.add_between(BetweenFactor((0, i), (0, j), Rm, tm, sq,
                                     is_loop=True))
        planted.append(outlier)
    fg.set_prior((0, 0))
    return fg, np.asarray(planted)


def _graph_ate(world, fg, t):
    from cslam_tpu_torch.swarm_slice import trajectory_ate
    t = t.cpu().numpy()
    est = {r: np.stack([t[fg.key_to_index[(r, k)]]
                        for k in range(world.n_poses)])
           for r in range(world.n_robots)}
    return trajectory_ate(world, est)


def check_pgo_parity(res, ref, what, t_atol=1e-3, gnc_slack=0):
    """tests/test_parallel.py's iteration-parity tolerances (equal GNC
    rounds and t_atol 1e-3 unless a caller states otherwise)."""
    errs = {"initial_cost_rel": abs(float(res.initial_cost) -
                                    float(ref.initial_cost)) /
            abs(float(ref.initial_cost)),
            "cost_abs": abs(float(res.cost) - float(ref.cost)),
            "weights_max_abs": float((res.weights - ref.weights).abs().max()),
            "t_max_abs": float((res.t - ref.t).abs().max())}
    ok = (abs(res.gnc_iters - ref.gnc_iters) <= gnc_slack
          and errs["initial_cost_rel"] <= 1e-5
          and errs["cost_abs"] <= 1e-8 + 1e-3 * abs(float(ref.cost))
          and errs["weights_max_abs"] <= 1e-2 and errs["t_max_abs"] <= t_atol)
    if not ok:
        raise AssertionError(f"{what}: GNC rounds {res.gnc_iters} vs "
                             f"{ref.gnc_iters}, {errs}, t_atol {t_atol}, "
                             f"GNC slack {gnc_slack}")
    return dict(errs, gnc_iters=res.gnc_iters)


@contextlib.contextmanager
def deterministic():
    """Deterministic CUDA algorithms in this process (index_add_ without
    atomics), so that a solve repeats bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _timed(solve):
    t = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def _solve_summary(world, fg, res, wall_s):
    return {"gnc_iters": res.gnc_iters, "cost": float(res.cost),
            "ate": _graph_ate(world, fg, res.t), "solve_s": wall_s}


def pgo_references(world, fg, multiple):
    """The single-card solves of the slice's 4000-pose graph that the
    meshes are held to, on rank 0 with deterministic algorithms: at the
    slice's PGOConfig(15, 80) and at MULTICHIP_CONVERGED, each on the
    robot-sorted arrays and on the same factors in insertion order (a
    witness of what the order of the sums alone does, without a mesh)."""
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.mission import MISSION_PGO
    g = fg.to_arrays(edge_bucket_multiple=multiple, sort_by_robot=True,
                     device="cuda")
    g_other = fg.to_arrays(edge_bucket_multiple=multiple,
                           sort_by_robot=False, device="cuda")
    if g_other.e_i.shape != g.e_i.shape:
        raise AssertionError("the two factor orders bucket differently")
    cfgs = {"slice": MISSION_PGO._replace(linear_solver="pcg"),
            "converged": MISSION_PGO._replace(linear_solver="pcg",
                                              **MULTICHIP_CONVERGED)}
    out = {"graph": g, "cfg": cfgs, "result": {}, "report": {
        "poses": fg.num_nodes, "factors": fg.num_factors,
        "ate_odometry": _graph_ate(world, fg, g.t)}}
    with deterministic():
        for name, cfg in cfgs.items():
            res, wall = _timed(lambda: pgo.gnc_optimize(g, cfg))
            other, wall_other = _timed(lambda: pgo.gnc_optimize(g_other,
                                                                cfg))
            out["result"][name] = res
            out["report"][name] = {
                "single": _solve_summary(world, fg, res, wall),
                "single_other_order": dict(
                    _solve_summary(world, fg, other, wall_other),
                    t_max_abs_vs_single=float((other.t - res.t).abs().max()),
                    cost_rel_vs_single=abs(float(other.cost) -
                                           float(res.cost)) /
                    float(res.cost),
                    weights_max_abs_vs_single=float(
                        (other.weights - res.weights).abs().max()))}
    spread = out["report"]["converged"]["single_other_order"]
    out["t_atol"] = max(1e-3, MULTICHIP_T_SPREAD *
                        spread["t_max_abs_vs_single"])
    return out


def multichip_pgo(mesh, world, fg, refs):
    """Stage 3: the slice's robot-sorted 4000-pose graph through the
    factor-sharded solve, against the single-card solves of
    pgo_references (all on PCG, the sharded solve's only linear solver).
    A one-rank mesh runs the slice's PGOConfig(15, 80) under
    deterministic algorithms and must end bit for bit where the single
    card does: the mesh path itself changes nothing. More ranks sum in
    another order, which moves the slice's solve as far as the single
    card's own other factor order does; they are held at
    MULTICHIP_CONVERGED to tests/test_parallel.py's iteration-parity
    tolerances and ATE within 1e-3 m of the single card's, except
    (a) t, held to MULTICHIP_T_SPREAD times the single card's spread
    between the two factor orders (float32 fixes this graph's converged
    poses to mm, not 1e-3 m), and (b) the GNC round count, within one
    of the single card's: GNC stops in the first round whose weights
    are binary and stable after two LM steps, and which round that is
    depends on rounding (ROADMAP queue 3)."""
    from cslam_tpu_torch.parallel.distributed_pgo import \
        distributed_gnc_optimize
    g = refs["graph"]
    shard = g.e_i.shape[0] // mesh.size
    name = "slice" if mesh.size == 1 else "converged"
    cfg, single = refs["cfg"][name], refs["result"][name]
    with deterministic() if mesh.size == 1 else contextlib.nullcontext():
        res, wall = _timed(lambda: distributed_gnc_optimize(mesh, g, cfg))
    out = dict(_solve_summary(world, fg, res, wall), setting=name,
               live_factors_per_shard=g.edge_mask.reshape(
                   mesh.size, shard).sum(1).tolist(),
               t_max_abs_vs_single=float((res.t - single.t).abs().max()),
               closures_classified_otherwise=int(
                   ((res.weights > 0.5) != (single.weights > 0.5)).sum()))
    if mesh.size == 1:
        same = (res.gnc_iters == single.gnc_iters and
                torch.equal(res.t, single.t) and
                torch.equal(res.R, single.R) and
                torch.equal(res.weights, single.weights) and
                float(res.cost) == float(single.cost))
        if not same:
            raise AssertionError(f"the one-rank mesh's solve is not the "
                                 f"single card's: {out}")
        out["bitwise_equal_to_single"] = True
        return out
    out["parity"] = dict(check_pgo_parity(
        res, single, f"{fg.num_nodes}-pose converged solve",
        t_atol=refs["t_atol"], gnc_slack=1),
        t_atol=refs["t_atol"], gnc_iters_single=single.gnc_iters)
    ate_single = refs["report"][name]["single"]["ate"]
    if not abs(out["ate"] - ate_single) <= 1e-3:
        raise AssertionError(f"{fg.num_nodes}-pose converged solve: ATE "
                             f"{out['ate']} vs {ate_single}")
    return out


def multichip_oracle(mesh):
    """The port's pgo_oracle on tests/test_pgo_oracle.py's graph at
    MULTICHIP_ORACLE["poses"] poses with planted outliers, as that test
    holds the solver: the single-card and the sharded solve (both PCG,
    on the same robot-sorted arrays) each reject the planted outliers as
    the oracle does, cost within 1%, poses within 2% of the
    trajectory's scale; and the two solves agree to
    tests/test_parallel.py's iteration-parity tolerances."""
    from cslam_tpu_torch.backend import pgo, pgo_oracle
    from cslam_tpu_torch.parallel.distributed_pgo import \
        distributed_gnc_optimize
    o, dev = MULTICHIP_ORACLE, mesh.device
    fg, planted = oracle_graph(o["poses"], o["loops"], o["outlier_every"],
                               SEED)
    # one robot: the robot-sorted arrays keep the factors' order
    g = fg.to_arrays(edge_bucket_multiple=mesh.size, sort_by_robot=True,
                     device=dev)
    og = pgo_oracle.from_graph_arrays(g)
    t = time.perf_counter()
    ores = pgo_oracle.gnc_optimize(og)
    oracle_s = time.perf_counter() - t
    loops = og.is_loop
    if not (ores.weights[loops] < 0.5).tolist() == planted.tolist():
        raise AssertionError("the oracle does not reject the planted "
                             "outliers")
    out = {"poses": fg.num_nodes, "factors": fg.num_factors,
           "outliers": int(planted.sum()), "oracle_s": oracle_s,
           "oracle_cost": ores.cost}
    scale = np.linalg.norm(ores.t - ores.t.mean(0), axis=1).max()
    nf = len(og.e_i)
    cfg = pgo.PGOConfig(linear_solver="pcg")
    runs = {}
    for name, solve in (
            ("single", lambda: pgo.gnc_optimize(g, cfg)),
            ("distributed", lambda: distributed_gnc_optimize(mesh, g, cfg))):
        t = time.perf_counter()
        res = runs[name] = solve()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        rejected = (res.weights[:nf].cpu().numpy() < 0.5)[loops]
        cost_rel = abs(float(res.cost) - ores.cost) / ores.cost
        err = float(np.linalg.norm(
            res.t.cpu().numpy()[:fg.num_nodes] - ores.t, axis=1).max())
        if rejected.tolist() != planted.tolist() or not cost_rel < 0.01 \
                or not err < max(0.02 * scale, 0.02):
            raise AssertionError(f"{name} solve vs the oracle: rejected "
                                 f"{np.nonzero(rejected)[0].tolist()}, "
                                 f"cost {cost_rel}, poses {err}")
        out[name] = {"cost_rel_err": cost_rel, "max_pose_err": err,
                     "gnc_iters": res.gnc_iters, "solve_s": wall_s}
    out["parity"] = check_pgo_parity(runs["distributed"], runs["single"],
                                     f"{fg.num_nodes}-pose solve")
    return out


def multichip_protocol(mesh):
    """Stage 4: dryrun_multichip's elastic protocol, every elected
    optimizer solving on this mesh."""
    from cslam_tpu_torch.entry import _dryrun_protocol_on_mesh
    t = time.perf_counter()
    run = _dryrun_protocol_on_mesh(mesh, mesh.axis_name, mesh.size)
    if run.optimizers[0] != 0 or run.survivor_optimizer == 0:
        raise AssertionError(f"optimizers {run.optimizers}")
    return {"robots": max(mesh.size, 3), "optimizers": run.optimizers,
            "survivor_optimizer": run.survivor_optimizer,
            "shared_estimates": run.shared_estimates,
            "wall_s": time.perf_counter() - t}


def run_multichip_mesh(kp, n, backend, full, world, fg, refs):
    """One mesh of n ranks on `backend`: its stages (all four and the
    200-pose oracle check if `full`, else the sharded search and the
    4000-pose solve), each rank's backend and device, the kernel
    launches of its sharded searches summed over the ranks, and the
    children left after close()."""
    from cslam_tpu_torch.parallel import make_swarm_mesh
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    out = {"ranks": n, "backend": backend}
    t = time.perf_counter()
    mesh = make_swarm_mesh(n, device="cuda", backend=backend)
    try:
        out["startup_s"] = time.perf_counter() - t
        out["rank_devices"] = mesh.describe()
        stages = {}
        t = time.perf_counter()
        stages["knn"], out["knn_launches"], out["knn_launches_per_rank"] = \
            multichip_knn(mesh, kp, gen)
        stages["knn"]["wall_s"] = time.perf_counter() - t
        if full:
            t = time.perf_counter()
            stages["descriptors"] = multichip_descriptors(mesh)
            stages["descriptors"]["wall_s"] = time.perf_counter() - t
        t = time.perf_counter()
        stages["pgo"] = multichip_pgo(mesh, world, fg, refs)
        stages["pgo"]["wall_s"] = time.perf_counter() - t
        if full:
            t = time.perf_counter()
            stages["oracle"] = multichip_oracle(mesh)
            stages["oracle"]["wall_s"] = time.perf_counter() - t
            mesh.reset_launches()
            stages["protocol"] = multichip_protocol(mesh)
            stages["protocol"]["knn_launches"], _ = mesh.launches()
        out["stages"] = stages
    finally:
        mesh.close()
    out["children_left"] = len(multiprocessing.active_children())
    if out["children_left"]:
        raise AssertionError(f"{out['children_left']} children left")
    per_rank = out["knn_launches_per_rank"]
    if any(sum(r.values()) == 0 or 0 in r.values() for r in per_rank):
        raise AssertionError(f"a rank did not launch both kernels: "
                             f"{per_rank}")
    return out


def slice_pose_graph(res):
    """(world, graph) of the slice phase's pose graph: the same odometry
    and verified closures, rebuilt from its world."""
    world = res["world"]
    return world, swarm_pose_graph(world, [tuple(c) for c in
                                           res["loop_closures"]])


def multichip_phase(kp, card, res, cards_only=False):
    """Phase 17 in two parts, each under its own watchdog and with its
    own phase line: `multichip_reference`, the single-card solves of the
    slice's 4000-pose graph (rank 0 alone, no mesh), then `multichip`,
    the meshes. Returns the second part's fields."""
    world, fg = slice_pose_graph(res)
    count = torch.cuda.device_count()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    faulthandler.dump_traceback_later(MULTICHIP_WATCHDOG_S, exit=True)
    try:
        refs = pgo_references(world, fg, MULTICHIP["ranks"] * max(count, 1))
    finally:
        faulthandler.cancel_dump_traceback_later()
    phase("multichip_reference", t0, **refs["report"],
          t_atol=refs["t_atol"])
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(MULTICHIP_WATCHDOG_S, exit=True)
    try:
        fields = run_multichip_phase(kp, card, world, fg, refs, cards_only)
        fields["threads_left"] = live_non_daemon_threads()
    finally:
        faulthandler.cancel_dump_traceback_later()
    phase("multichip", t0, **fields)
    if fields["threads_left"]:
        raise AssertionError(f"threads left: {fields['threads_left']}")
    return fields


def run_multichip_phase(kp, card, world, fg, refs, cards_only=False):
    """Phase 17's meshes: d = 4 on cuda:0 (gloo) and d = 1 (NCCL) unless
    `cards_only`, and d = device_count (NCCL, one card per rank) where
    there are at least 2 cards; then the kernel's per-shard timings."""
    count = torch.cuda.device_count()
    meshes = [] if cards_only else [
        run_multichip_mesh(kp, MULTICHIP["ranks"], "gloo", True, world, fg,
                           refs),
        run_multichip_mesh(kp, 1, "nccl", False, world, fg, refs)]
    if count >= 2:
        meshes.append(run_multichip_mesh(kp, count, "nccl", True, world,
                                         fg, refs))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = MULTICHIP
    shard = dict(m, n_cap=m["n_cap"] // m["ranks"],
                 n_valid=m["n_cap"] // m["ranks"])
    timing = {}
    for label, shape in (("shard", shard), ("whole", m)):
        for dtype in (torch.float32, torch.bfloat16):
            inputs, err = check_knn_case(kp, shape["n_cap"],
                                         shape["n_valid"], shape["dim"],
                                         shape["batch"], shape["k"], dtype,
                                         gen)
            timing[f"{label}_{dtype}"] = timing_row(kp, inputs, shape,
                                                    dtype, err, 50)
            del inputs
    launches = {name: sum(mm["knn_launches"][name] for mm in meshes)
                + sum(mm["stages"].get("protocol", {}).get(
                    "knn_launches", {}).get(name, 0) for mm in meshes)
                for name in kp.cosine_topk_pallas.launches}
    return {"meshes": meshes, "kernel_timing": timing,
            "knn_launches": launches, "card": card,
            "cards": nvidia_smi_cards(), "device_count": count}


# ----------------------------------------------------------------------
# phases 15-16: training and tooling
# ----------------------------------------------------------------------

TRAINERS = ("superpoint", "lightglue", "cosplace", "netvlad")
# steps each trainer takes through its main code path on the card, at
# the reference CLI's shapes (SuperPoint batch 16 at 64x96 from scratch;
# LightGlue batch 16, K = 96, 3 layers; CosPlace 8 places x 2 views at
# crop 224; NetVLAD crop 128 after data_driven_init)
TRAIN_STEPS = {"superpoint": 40, "lightglue": 40, "cosplace": 30,
               "netvlad": 30}
TRAIN_ARGS = {"superpoint": ["--batch", "16", "--height", "64",
                             "--width", "96"],
              "lightglue": ["--batch", "16", "--keypoints", "96",
                            "--layers", "3"],
              "cosplace": ["--places", "8", "--views", "2",
                           "--crop-size", "224"],
              "netvlad": ["--places", "8", "--views", "2",
                          "--crop-size", "128"]}
LEARNING_WINDOW = 5
# The learning gate: the mean loss of the last LEARNING_WINDOW steps over
# that of the first must stay below these ratios. The reference trainers
# (cslam_tpu, JAX on the CPU, seed 0, main's loop at TRAIN_STEPS and the
# shapes above; tests/reference_learning_curves.py) reach SuperPoint
# 0.4931, LightGlue 0.7196, CosPlace 0.1575 and NetVLAD 0.3200; each gate
# sits halfway between that and 1 (no learning), since the port starts
# from another random init (torch's generator, Flax's distributions).
LEARNING_MAX_RATIO = {"superpoint": 0.747, "lightglue": 0.860,
                      "cosplace": 0.579, "netvlad": 0.660}
# card against CPU for one step of each trainer at f32 (TF32 off; the
# CPU side with oneDNN off): the loss within 1e-4 relative, each
# gradient within a relative norm of 1e-4 (or, where f32 cannot hold
# that, held to a float64 gradient: see train_parity), the updated
# parameters within 1e-6 where the gradient is clear of zero
PARITY_LOSS_RTOL = 1e-4
PARITY_GRAD_RTOL = 1e-4
PARITY_PARAM_ATOL = 1e-6
PARITY_GRAD_CLEAR = 1e-5     # 1000 x Adam's eps
# On these batches f32 gradients are ill-conditioned (ROADMAP queue 3):
# against a float64 gradient, the worst tensor of six f32 evaluations
# (CPU with oneDNN on / off, card with cuDNN default / deterministic /
# benchmark / off) spread 11x for NetVLAD (4.4e-4 to 4.9e-3) and 28x
# for SuperPoint (4.5e-4 to 1.25e-2), the card's the worst for one and
# the CPU's for the other (tools/grad_precision.py on an NVIDIA H100
# 80GB HBM3 at 700.00 W). A tensor whose card and CPU gradients differ
# by more than PARITY_GRAD_RTOL is held to the float64 gradient within
# this factor of the CPU's worst tensor.
PARITY_F32_SPREAD = 10.0
HA_WARPS = 48
HA_FRAMES = (0,)             # tests/data/real_seq frames, 192x256
HA_HEAT_TOL = 1e-5
KITTI_EVAL = ["--robots", "4", "--kf-distance", "3.0", "--drift", "0.04",
              "--rounds", "4"]
KITTI_EVAL_DEADLINE_S = 300
REAL_SEQ = REPO / "tests" / "data" / "real_seq"
# sha256 of the 30 frames of tests/data/real_seq*/image_2, decoded to
# RGB uint8 by PIL 12.1.0 (the CPU tests' decoder)
REAL_FRAMES_SHA256 = ("5f3aee6aa5c3f1564a240080d43a96ce"
                      "603326ade2e64e3362d5cd51f40784b1")


def _trainer(name):
    """The port's trainer module of `name`."""
    import importlib
    return importlib.import_module(f"cslam_tpu_torch.models.train_{name}")


def _parity_case(name, rng):
    """(f32 model, host batch, lr) of one step of `name` at its CLI's
    shapes (SuperPoint's batch cut to 8: the CPU's step is the phase's
    longest); the model carries Flax-default random weights (NetVLAD's
    after data_driven_init)."""
    from cslam_tpu_torch.models.cosplace import GeoLocalizationNet, \
        flax_init_
    from cslam_tpu_torch.models.lightglue import LightGlueNet
    from cslam_tpu_torch.models.netvlad import NetVLADNet
    from cslam_tpu_torch.models.superpoint import SuperPointNet
    mod = _trainer(name)
    if name == "superpoint":
        return (flax_init_(SuperPointNet(dtype=torch.float32), SEED),
                (mod._batch(rng, 8, 64, 96),), 1e-3)
    if name == "lightglue":
        return (flax_init_(LightGlueNet(num_layers=3), SEED),
                (mod.make_match_batch(rng, 16, K=96),), 2e-4)
    places = _trainer("cosplace")
    if name == "cosplace":
        model = flax_init_(GeoLocalizationNet(dtype=torch.float32), SEED)
        crop, lr = 224, 1e-3
    else:
        model = mod.data_driven_init(
            flax_init_(NetVLADNet(dtype=torch.float32), SEED), rng, 128)
        crop, lr = 128, 1e-4
    world = places.make_world(int(rng.integers(2**31)), n=160)
    return model, places.make_batch(rng, world, 8, 2, 0.3, 0.05, crop), lr


def _float64_gradient(name, model, batch, device):
    """Every parameter's gradient of one step's loss of `name` on `batch`
    computed by a float64 copy of `model` (every conv computing in
    float64) on `device`: the arbiter of the f32 gradients."""
    import copy
    m = copy.deepcopy(model).cpu()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    if isinstance(getattr(m, "dtype", None), torch.dtype):
        m.dtype = torch.float64
    m = m.double().to(device).train()
    trainer = _trainer(name)

    def t(a):
        a = np.asarray(a)
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x.double() if a.dtype.kind == "f" else x.long()).to(device)

    if name == "superpoint":
        im0, im1, lab0, lab1, wc, v1, dw0, dw1 = map(t, batch[0])
        det0, desc0 = m(im0)
        det1, desc1 = m(im1)
        loss = trainer.detector_loss(det0, lab0, dw0) + \
            trainer.detector_loss(det1, lab1, v1 * dw1) + \
            trainer.descriptor_loss(desc0, desc1, lab0, wc, v1)
    elif name == "lightglue":
        size = torch.tensor([160.0, 120.0], dtype=torch.float64,
                            device=device)
        loss = torch.mean(trainer.pair_losses(m, *map(t, batch[0]), size))
    else:
        loss = _trainer("cosplace").supcon_loss(m(t(batch[0])),
                                                t(batch[1]))
    loss.backward()
    return {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}


def train_parity(name, card="cuda"):
    """One step of `name`'s build_train_step on `card` and on the CPU
    from the same weights and host batch, at f32. Raises unless the
    losses agree within PARITY_LOSS_RTOL; each gradient within
    PARITY_GRAD_RTOL (relative norm) of the CPU's, or, where f32 cannot
    hold that, no farther from a float64 gradient than PARITY_F32_SPREAD
    times the CPU f32 gradient's worst tensor is from it (sums that
    cancel, and flat render regions at ReLU's kink whose masks f32
    rounding decides, make some tensors' f32 gradients 1e-4-1e-2 off on
    either device, each in other tensors); and the updated parameters
    within PARITY_PARAM_ATOL
    on the components whose CPU gradient exceeds ten times the tensor's
    largest card-CPU gradient difference and PARITY_GRAD_CLEAR (Adam's
    first update is lr * g / (|g| + 1e-8), about lr * sign(g): a
    component nearer zero may step either way, or by another share of
    lr). Returns the numbers."""
    import copy
    rng = np.random.default_rng(SEED)
    cpu_model, batch, lr = _parity_case(name, rng)
    g64 = _float64_gradient(name, cpu_model, batch, card)
    card_model = copy.deepcopy(cpu_model).to(card)
    mod = _trainer(name)
    losses, grads, after = {}, {}, {}
    for where, model in (("cpu", cpu_model), ("card", card_model)):
        with torch.backends.mkldnn.flags(enabled=False):
            _, step = mod.build_train_step(model, lr, 10)
            loss = step(*batch)
        losses[where] = float(loss[0] if isinstance(loss, tuple) else loss)
        grads[where] = {k: p.grad.detach().cpu().numpy()
                        for k, p in model.named_parameters()}
        after[where] = {k: p.detach().cpu().numpy()
                        for k, p in model.named_parameters()}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))

    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    e_cpu = {k: rel(g, g64[k]) for k, g in grads["cpu"].items()}
    e_card = {k: rel(g, g64[k]) for k, g in grads["card"].items()}
    cpu_worst = max(e_cpu.values())
    grad_rel, beyond = {}, {}
    param_err, param_worst, n, n_clear = 0.0, None, 0, 0
    for k, g in grads["cpu"].items():
        diff = grads["card"][k] - g
        grad_rel[k] = rel(grads["card"][k], g)
        if grad_rel[k] > PARITY_GRAD_RTOL:
            beyond[k] = (grad_rel[k], e_card[k], e_cpu[k])
        clear = np.abs(g) > max(10 * float(np.abs(diff).max()),
                                PARITY_GRAD_CLEAR)
        if clear.any():
            err = float(np.abs(after["card"][k] - after["cpu"][k])[
                clear].max())
            if err > param_err:
                param_err, param_worst = err, k
        n += g.size
        n_clear += int(clear.sum())
    failed = {k: v for k, v in beyond.items()
              if v[1] > PARITY_F32_SPREAD * cpu_worst}
    worst = max(grad_rel, key=grad_rel.get)
    out = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
           "loss_rel": loss_rel, "grad_worst_rel": grad_rel[worst],
           "grad_worst_tensor": worst, "tensors": len(grad_rel),
           "n_beyond_rtol": len(beyond),
           "beyond_rtol_card_cpu_vs_float64": dict(sorted(
               beyond.items(), key=lambda kv: -kv[1][0])[:4]),
           "float64_worst_card": max(e_card.values()),
           "float64_worst_cpu": cpu_worst,
           "param_max_abs": param_err, "param_worst_tensor": param_worst,
           "param_share_compared": n_clear / n}
    if failed or not (loss_rel <= PARITY_LOSS_RTOL and
                      param_err <= PARITY_PARAM_ATOL):
        raise AssertionError(f"{name} step, card vs CPU: {out}; "
                             f"failed {failed}")
    return out


def _shipped_shapes(name):
    from cslam_tpu_torch.models import zoo
    with np.load(zoo.shipped_checkpoint(name)) as data:
        return {k: tuple(data[k].shape) for k in data.files}


def _file_shapes(path):
    with np.load(path) as data:
        return {k: tuple(data[k].shape) for k in data.files}


def _learning(losses):
    first = float(np.mean(losses[:LEARNING_WINDOW]))
    last = float(np.mean(losses[-LEARNING_WINDOW:]))
    return first, last, last / first


class _Forward(torch.nn.Module):
    """`model` called on fixed arguments, for forward_flops' hooks."""

    def __init__(self, model, args):
        super().__init__()
        self.model, self.args = model, args

    def forward(self, _):
        return self.model(*self.args)


def _step_bound_ms(model, args, dtype):
    """Three forwards' operations (forward_flops: backward is two more
    products of the forward's size) over the card's peak for `dtype`:
    the least time of one training step's products."""
    return 3 * forward_flops(_Forward(model, args), None) / \
        PEAK_FLOPS[dtype] * 1e3


def _reload_check(name, model, path, card, extra=None):
    """Load the checkpoint at `path` back through the port's runtime
    wrapper on the card; returns the max abs difference of its outputs
    from the trained module's on one input (raises unless 0 where the
    wrapper computes in the module's precision)."""
    from cslam_tpu_torch.models.cosplace import CosPlace, embed, \
        l2_normalize, load_flat_weights, preprocess, to_device
    from cslam_tpu_torch.models.lightglue import LightGlue, \
        normalize_keypoints
    from cslam_tpu_torch.models.netvlad import NetVLAD
    from cslam_tpu_torch.models.superpoint import SuperPoint, \
        SuperPointNet, superpoint_state
    model.eval()
    rng = np.random.default_rng(SEED + 1)
    with torch.no_grad():
        if name == "superpoint":
            wrapper = SuperPoint(checkpoint=path, device=card)
            net = load_flat_weights(SuperPointNet(dtype=torch.float32),
                                    superpoint_state(path)).to(card)
            x = torch.rand((2, 64, 96, 1), device=card)
            got, want = net(x), model(x)
            state_equal = all(torch.equal(
                wrapper.model.state_dict()[k].float(), v.float())
                for k, v in model.state_dict().items())
        elif name == "lightglue":
            wrapper = LightGlue(checkpoint=path, num_layers=3, device=card)
            b = _trainer("lightglue").make_match_batch(rng, 2, K=96)
            t = [torch.from_numpy(a).to(card) for a in b[:6]]
            size = torch.tensor([160.0, 120.0], device=card)
            args = (t[0], normalize_keypoints(t[1], size), t[2], t[3],
                    normalize_keypoints(t[4], size), t[5])
            got, want = wrapper.model(*args), model(*args)
            state_equal = True
        elif name == "cosplace":
            wrapper = CosPlace({"frontend.nn_checkpoint": path,
                                "frontend.image_crop_size": 224},
                               device=card)
            imgs = np.stack(render_pool(4, SEED))[..., None].repeat(3, -1)
            got = torch.from_numpy(wrapper.compute_embeddings_batch(imgs))
            want = torch.from_numpy(embed(model, preprocess(imgs, 224),
                                          card))
            state_equal = all(torch.equal(
                wrapper.model.state_dict()[k], v)
                for k, v in model.state_dict().items())
        else:
            pca_path = extra
            wrapper = NetVLAD({"frontend.nn_checkpoint": path,
                               "frontend.netvlad.pca_checkpoint": pca_path,
                               "frontend.image_crop_size": 128},
                              device=card)
            imgs = np.stack(render_pool(4, SEED))[..., None].repeat(3, -1)
            got = torch.from_numpy(wrapper.compute_embeddings_batch(imgs))
            with np.load(pca_path) as data:
                mean = torch.from_numpy(data["mean"]).to(card)
                comps = torch.from_numpy(data["components"]).to(card)
            raw = model(to_device(preprocess(imgs, 128), card))
            want = l2_normalize((raw - mean) @ comps.T, dim=-1).cpu()
            state_equal = all(torch.equal(
                wrapper.model.state_dict()[k], v)
                for k, v in model.state_dict().items())
    if isinstance(got, tuple):
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    else:
        err = float((got.cpu() - want.cpu()).abs().max())
    if err != 0.0 or not state_equal:
        raise AssertionError(f"{name}: reloaded checkpoint differs "
                             f"(max abs {err}, state equal {state_equal})")
    return err


def run_trainer(name, card, tmp):
    """`name`'s main code path (its `train`) on the card for
    TRAIN_STEPS[name] steps at the CLI's shapes, the checkpoint into
    `tmp`: ms per step on the device (CUDA events) and host batch ms
    (means after the first step), the step's bound, the loss
    trajectory, the learning gate, the checkpoint's keys and shapes
    against the shipped file's and its reload through the port's
    wrapper."""
    mod = _trainer(name)
    out_path = os.path.join(tmp, f"{name}.npz")
    argv = ["--steps", str(TRAIN_STEPS[name]), "--seed", str(SEED),
            "--out", out_path] + TRAIN_ARGS[name]
    if name == "netvlad":
        argv += ["--pca-out", os.path.join(tmp, "netvlad_pca.npz")]
    if torch.device(card).type == "cpu":     # a rehearsal on the CPU
        argv.append("--cpu")
    args = mod.parse_args(argv)
    t0 = time.perf_counter()
    res = mod.train(args, log=lambda *a, **k: None)
    model, losses, step_ms, batch_ms = res[:4]
    best = res[4] if name in ("cosplace", "netvlad") else None
    wall_s = time.perf_counter() - t0
    if next(model.parameters()).device.type != torch.device(card).type:
        raise AssertionError(f"{name} trained off {card}")
    rng = np.random.default_rng(SEED)
    if name == "superpoint":   # two views per step
        x = torch.zeros((16, 64, 96, 1), device=card)
        bound = 2 * _step_bound_ms(model, (x,), torch.float32)
    elif name == "lightglue":
        b = mod.make_match_batch(rng, 16, K=96)
        bound = _step_bound_ms(model, [torch.from_numpy(a).to(card)
                                       for a in b[:6]], torch.float32)
    else:
        crop = 224 if name == "cosplace" else 128
        x = torch.zeros((16, crop, crop, 3), device=card)
        bound = _step_bound_ms(model, (x,), torch.bfloat16)
    first, last, ratio = _learning(losses)
    shipped = {"superpoint": "superpoint_synth.npz",
               "lightglue": "lightglue_synth.npz",
               "cosplace": "cosplace_synth.npz",
               "netvlad": "netvlad_synth.npz"}[name]
    same_layout = _file_shapes(out_path) == _shipped_shapes(shipped)
    extra = os.path.join(tmp, "netvlad_pca.npz") if name == "netvlad" \
        else None
    if extra and _file_shapes(extra) != _shipped_shapes(
            "netvlad_pca_synth.npz"):
        raise AssertionError("netvlad: the PCA file's layout differs from "
                             "the shipped one")
    reload_err = _reload_check(name, model, out_path, card, extra)
    steady = step_ms[1:] or step_ms
    fields = {"steps": len(losses), "wall_s": wall_s,
              "step_ms": float(np.mean(steady)),
              "first_step_ms": step_ms[0],
              "host_batch_ms": float(np.mean(batch_ms[1:] or batch_ms)),
              "step_bound_ms": bound,
              "losses": [round(v, 5) for v in losses],
              "loss_first": first, "loss_last": last,
              "learning_ratio": ratio,
              "learning_max_ratio": LEARNING_MAX_RATIO[name],
              "checkpoint_layout_as_shipped": same_layout,
              "reload_max_abs": reload_err}
    if best is not None:
        fields["best_recall_at_1"] = best
    if not ratio < LEARNING_MAX_RATIO[name]:
        raise AssertionError(f"{name} did not learn: {fields}")
    if not same_layout:
        raise AssertionError(f"{name}: the checkpoint's keys or shapes "
                             f"differ from {shipped}'s")
    return fields


def real_gray_frames(indices=(0, 9)):
    """Frames of tests/data/real_seq as (H, W) f32 in [0, 1]."""
    from cslam_tpu_torch.utils.image_sequence import open_sequence
    seq = open_sequence(str(REAL_SEQ))
    return [seq.frame(i).astype(np.float32).mean(-1) / 255.0
            for i in indices]


def check_homographic_adaptation(card):
    """aggregate_heatmap from the shipped SuperPoint (f32) on the card
    against the CPU, HA_WARPS warps of real frames: heat within
    HA_HEAT_TOL, counts equal, pseudo-corner counts equal; returns the
    numbers and the card's seconds per frame."""
    from cslam_tpu_torch.models import convert, zoo
    from cslam_tpu_torch.models.cosplace import load_flat_weights
    from cslam_tpu_torch.models.homographic_adaptation import \
        aggregate_heatmap, apply_superpoint, pseudo_corners
    from cslam_tpu_torch.models.superpoint import SuperPointNet
    state = convert.superpoint_state_dict(convert.load_flat(
        zoo.shipped_checkpoint("superpoint_synth.npz")))
    nets = {d: load_flat_weights(SuperPointNet(dtype=torch.float32),
                                 state).to(d).eval()
            for d in ("cpu", card)}
    out = {"warps": HA_WARPS, "frames": []}
    for i, img in enumerate(real_gray_frames(HA_FRAMES)):
        res, secs = {}, {}
        for d, net in nets.items():
            t = time.perf_counter()
            with torch.backends.mkldnn.flags(enabled=False):
                res[d] = aggregate_heatmap(apply_superpoint, net, img,
                                           np.random.default_rng(SEED + i),
                                           n_warps=HA_WARPS)
            secs[d] = time.perf_counter() - t
        heat_err = float(np.abs(res[card][0] - res["cpu"][0]).max())
        corners = {d: len(pseudo_corners(res[d][0], threshold=0.010))
                   for d in res}
        frame = {"heat_max_abs": heat_err,
                 "counts_equal": bool(np.array_equal(res[card][1],
                                                     res["cpu"][1])),
                 "pseudo_corners_card": corners[card],
                 "pseudo_corners_cpu": corners["cpu"],
                 "card_s": secs[card], "cpu_s": secs["cpu"]}
        out["frames"].append(frame)
        if not (heat_err <= HA_HEAT_TOL and frame["counts_equal"] and
                corners[card] == corners["cpu"]):
            raise AssertionError(f"homographic adaptation, card vs CPU: "
                                 f"{frame}")
    return out


def run_training_phase(card):
    """Phase 15: card-vs-CPU step parity and the main-path runs of the
    four trainers, then homographic adaptation; returns its fields."""
    fields = {"parity": {}, "trainers": {}}
    for name in TRAINERS:
        t = time.perf_counter()
        fields["parity"][name] = dict(train_parity(name, card),
                                      s=time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as tmp:
        for name in TRAINERS:
            fields["trainers"][name] = run_trainer(name, card, tmp)
    t = time.perf_counter()
    fields["homographic_adaptation"] = dict(
        check_homographic_adaptation(card), s=time.perf_counter() - t)
    fields["card"] = card
    return fields


# ----------------------------------------------------------------------
# the real-pixel gates (tests/test_real_pixels.py, tests/test_tum_sequence
# .py); each takes a device, and the CPU tests call them with "cpu"
# ----------------------------------------------------------------------

REAL_Z = 2.0   # tests/data/real_seq/meta.json scene_depth_m
REAL_ROT_TOL, REAL_T_TOL = 0.05, 0.08


def _real_seq():
    from cslam_tpu_torch.utils.image_sequence import open_sequence
    return open_sequence(str(REAL_SEQ))


def _rel_pose(seq, i, j):
    R, t = seq.poses
    return R[i].T @ R[j], R[i].T @ (t[j] - t[i])


def _real_pose_errors(name, pose, Rr, tr):
    """Geodesic rotation and translation error of `pose` against the
    ground truth; raises beyond the reference's tolerances."""
    Re = np.asarray(pose[0]) @ Rr.T
    angle = float(np.arccos(np.clip((np.trace(Re) - 1.0) / 2.0, -1.0,
                                    1.0)))
    err = float(np.linalg.norm(np.asarray(pose[1]) - tr))
    if not (angle < REAL_ROT_TOL and err < REAL_T_TOL):
        raise AssertionError(f"{name}: rotation {angle} rad, "
                             f"translation {err} m")
    return angle, err


def check_real_reader():
    """The reader on real_seq's KITTI layout (test_real_pixels.py:73)."""
    from cslam_tpu_torch.utils.image_sequence import GlobImageSequence, \
        KittiOdometrySequence
    seq = _real_seq()
    intr = seq.intrinsics()
    img = seq.frame(0)
    Rr, tr = _rel_pose(seq, 0, 14)
    glob_seq = GlobImageSequence(str(REAL_SEQ / "image_2"), fps=5.0)
    ok = (isinstance(seq, KittiOdometrySequence) and len(seq) == 16 and
          intr.fx == 200.0 and intr.cx == 128.0 and
          abs(intr.baseline - 0.1) < 1e-6 and img.shape == (192, 256, 3)
          and img.dtype == np.uint8 and abs(seq.stamp(3) - 0.3) < 1e-9 and
          len(seq.poses[1]) == 16 and np.allclose(Rr, np.eye(3), atol=1e-8)
          and np.allclose(tr, [0.04, 0.04, 0.0], atol=1e-6) and
          len(glob_seq) == 16 and abs(glob_seq.stamp(2) - 0.4) < 1e-9 and
          glob_seq.intrinsics().cx == 128.0)
    if not ok:
        raise AssertionError("the KITTI-layout reader's gates failed")
    return {"frames": len(seq), "fx": intr.fx, "baseline": intr.baseline}


def check_superpoint_real_pixels(device):
    """The shipped SuperPoint fires on real frames: >= 60 of 128
    keypoints on frames 0, 5, 9, 14 (test_real_pixels.py:104)."""
    from cslam_tpu_torch.models import zoo
    from cslam_tpu_torch.models.superpoint import SuperPoint
    sp = SuperPoint(checkpoint=zoo.shipped_checkpoint(
        "superpoint_synth.npz"), max_keypoints=128, device=device)
    seq = _real_seq()
    counts = []
    for i in (0, 5, 9, 14):
        gray = np.asarray(seq.frame(i), np.float32).mean(-1) / 255.0
        counts.append(int(sp.extract_features(gray)[3].sum()))
    if min(counts) < 60:
        raise AssertionError(f"SuperPoint on real pixels: {counts}")
    return counts


def _real_handler(rid, n_robots, bus, min_inliers, device):
    from cslam_tpu_torch.comm.bus import ManualClock
    from cslam_tpu_torch.frontend.rgbd_handler import RGBDHandler
    return RGBDHandler({"robot_id": rid, "max_nb_robots": n_robots,
                        "frontend.features": "learned",
                        "frontend.pnp_min_inliers": min_inliers},
                       bus, ManualClock(), max_keypoints=128, device=device)


def _feed_real(handler, seq, indices):
    intr = seq.intrinsics()
    R, t = seq.poses
    depth = np.full((192, 256), REAL_Z, np.float32)
    for local_id, i in enumerate(indices):
        handler.add_sensor_data(seq.frame(i), depth, intr, (R[i], t[i]))
        if handler.process_new_sensor_data() != local_id:
            raise AssertionError(f"frame {i} made no keyframe {local_id}")


def _scrambled(frame, seed=5):
    """Frame 8's texture in shuffled, flipped 16x16 blocks: real local
    statistics without the scene's geometry (test_real_pixels.py:165)."""
    rng = np.random.default_rng(seed)
    blocks = [np.ascontiguousarray(
        frame[y:y + 16, x:x + 16][:: rng.choice([-1, 1]),
                                  :: rng.choice([-1, 1])])
        for y in range(0, 192, 16) for x in range(0, 256, 16)]
    order = rng.permutation(len(blocks))
    out = np.zeros_like(frame)
    k = 0
    for y in range(0, 192, 16):
        for x in range(0, 256, 16):
            out[y:y + 16, x:x + 16] = blocks[order[k]]
            k += 1
    return out


def check_real_intra_revisit(device):
    """Real frames through the handler (shipped SuperPoint + LightGlue +
    RANSAC, 45 inliers): frame 14's revisit of frame 0 verifies with the
    ground-truth relative pose; a scrambled frame does not
    (test_real_pixels.py:127)."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter
    seq = _real_seq()
    router = InProcessRouter()
    bus = InProcessBus(router, 0)
    handler = _real_handler(0, 1, bus, 45, device)
    results = []
    bus.subscribe("cslam/intra_robot_loop_closure", results.append)
    try:
        _feed_real(handler, seq, range(16))
        bus.publish("cslam/local_keyframe_match",
                    msgs.LocalKeyframeMatch(keyframe0_id=0,
                                            keyframe1_id=14))
        router.spin_until_idle()
        if len(results) != 1 or not results[0].success:
            raise AssertionError("real revisit 0-14 not verified")
        errors = _real_pose_errors("real revisit", results[0].pose,
                                   *_rel_pose(seq, 0, 14))
        R, t = seq.poses
        handler.add_sensor_data(_scrambled(seq.frame(8).copy()),
                                np.full((192, 256), REAL_Z, np.float32),
                                seq.intrinsics(), (R[8], t[8]))
        kf = handler.process_new_sensor_data()
        results.clear()
        bus.publish("cslam/local_keyframe_match",
                    msgs.LocalKeyframeMatch(keyframe0_id=0,
                                            keyframe1_id=kf))
        router.spin_until_idle()
        if len(results) != 1 or results[0].success:
            raise AssertionError("a scrambled frame verified")
    finally:
        handler.close()
    return errors


def check_real_inter_revisit(device):
    """Two robots replay halves of real_seq; the broker round trip
    verifies robot 1's frame 14 against robot 0's frame 0 with the
    ground-truth pose (test_real_pixels.py:185)."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter
    seq = _real_seq()
    router = InProcessRouter()
    buses = [InProcessBus(router, rid) for rid in (0, 1)]
    handlers = [_real_handler(rid, 2, buses[rid], 8, device)
                for rid in (0, 1)]
    results = []
    router.subscribe("/cslam/inter_robot_loop_closure", results.append)
    try:
        _feed_real(handlers[0], seq, range(0, 8))
        _feed_real(handlers[1], seq, range(8, 16))
        buses[0].publish("cslam/local_descriptors_request",
                         msgs.LocalDescriptorsRequest(
                             keyframe_id=0, matches_robot_id=[1],
                             matches_keyframe_id=[6]))
        router.spin_until_idle()
    finally:
        for h in handlers:
            h.close()
    if len(results) != 1 or not results[0].success or \
            (results[0].robot0_id, results[0].robot1_id) != (0, 1):
        raise AssertionError("real inter-robot revisit not verified")
    return _real_pose_errors("real inter-robot", results[0].pose,
                             *_rel_pose(seq, 0, 14))


def check_real_place_models(device):
    """The shipped CosPlace and NetVLAD rank the true revisit (frames 0
    and 14) above a different place (frame 7) on real pixels
    (test_real_pixels.py:214, :226)."""
    from cslam_tpu_torch.models.cosplace import CosPlace
    from cslam_tpu_torch.models.netvlad import NetVLAD
    seq = _real_seq()
    out = {}
    for name, cls, margin, floor in (("cosplace", CosPlace, 0.05, 0.9),
                                     ("netvlad", NetVLAD, 0.02, None)):
        model = cls({"frontend.nn_checkpoint": "shipped"}, device=device)
        e = {i: model.compute_embedding(seq.frame(i)) for i in (0, 7, 14)}
        revisit, far = float(e[0] @ e[14]), float(e[0] @ e[7])
        out[name] = (revisit, far)
        if not revisit > far + margin or (floor and not revisit > floor):
            raise AssertionError(f"{name} on real pixels: {out[name]}")
    return out


def write_tum_dir(root):
    """real_seq re-encoded as a TUM RGB-D directory with uint16 depth
    PNGs stamped 8 ms off the rgb (tests/test_tum_sequence.py's
    fixture)."""
    from PIL import Image
    from cslam_tpu_torch.utils.datasets import save_tum_trajectory
    src = _real_seq()
    root = Path(root)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_rows, depth_rows = [], []
    base = 1311868164.0
    for i in range(len(src)):
        stamp = base + 0.1 * i
        dstamp = stamp + 0.008
        rgb_name, depth_name = f"rgb/{stamp:.6f}.png", \
            f"depth/{dstamp:.6f}.png"
        frame = src.frame(i)
        Image.fromarray(frame).save(root / rgb_name)
        depth_u16 = np.full(frame.shape[:2], int(REAL_Z * 5000), np.uint16)
        depth_u16[0, 0] = 0
        Image.fromarray(depth_u16).save(root / depth_name)
        rgb_rows.append(f"{stamp:.6f} {rgb_name}")
        depth_rows.append(f"{dstamp:.6f} {depth_name}")
    (root / "rgb.txt").write_text(
        "# color images\n# timestamp filename\n" + "\n".join(rgb_rows))
    (root / "depth.txt").write_text(
        "# depth images\n# timestamp filename\n" + "\n".join(depth_rows))
    R, t = src.poses
    save_tum_trajectory(str(root / "groundtruth.txt"),
                        base + 0.1 * np.arange(len(src)), R, t)
    return str(root)


def check_tum_gates(device, root):
    """tests/test_tum_sequence.py on `device`: the TUM reader's
    association (every frame within 20 ms, none within 5 ms), the depth
    decode, and the handler's revisit 0-14 through the TUM path with the
    ground-truth pose."""
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter
    from cslam_tpu_torch.utils.image_sequence import TumRgbdSequence, \
        open_sequence
    seq = open_sequence(root)
    d = seq.depth(0)
    stamps, Rg, _ = seq.trajectory
    ok = (isinstance(seq, TumRgbdSequence) and len(seq) == 16 and
          abs(seq.stamp(1) - seq.stamp(0) - 0.1) < 1e-6 and
          seq.frame(0).shape == (192, 256, 3) and d.dtype == np.float32
          and abs(d[5, 5] - REAL_Z) < 1e-3 and d[0, 0] == 0.0 and
          seq.intrinsics().fx == 525.0 and len(stamps) == 16 and
          Rg.shape == (16, 3, 3) and
          len(TumRgbdSequence(root, max_dt=0.010)) == 16)
    try:
        TumRgbdSequence(root, max_dt=0.005)
        ok = False
    except ValueError:
        pass
    if not ok:
        raise AssertionError("the TUM reader's gates failed")
    src = _real_seq()
    R, t = src.poses
    router = InProcessRouter()
    bus = InProcessBus(router, 0)
    handler = _real_handler(0, 1, bus, 30, device)
    results = []
    try:
        for i in range(len(seq)):
            handler.add_sensor_data(seq.frame(i), seq.depth(i),
                                    src.intrinsics(), (R[i], t[i]))
            if handler.process_new_sensor_data() != i:
                raise AssertionError(f"TUM frame {i} made no keyframe")
        bus.subscribe("cslam/intra_robot_loop_closure", results.append)
        bus.publish("cslam/local_keyframe_match",
                    msgs.LocalKeyframeMatch(keyframe0_id=0,
                                            keyframe1_id=14))
        router.spin_until_idle()
    finally:
        handler.close()
    if len(results) != 1 or not results[0].success:
        raise AssertionError("TUM revisit 0-14 not verified")
    return _real_pose_errors("TUM revisit", results[0].pose,
                             *_rel_pose(src, 0, 14))


def check_real_pixel_gates(device, tmp):
    """Every real-pixel gate on `device`; returns their numbers."""
    return {"reader": check_real_reader(),
            "superpoint_keypoints": check_superpoint_real_pixels(device),
            "intra_revisit_rot_trans": check_real_intra_revisit(device),
            "inter_revisit_rot_trans": check_real_inter_revisit(device),
            "place_models_revisit_far": check_real_place_models(device),
            "tum_revisit_rot_trans": check_tum_gates(
                device, write_tum_dir(os.path.join(tmp, "tum")))}


def decoded_frames_digest():
    """sha256 of real_seq*'s frames as the port's reader decodes them,
    and whether it equals REAL_FRAMES_SHA256."""
    import glob
    import hashlib
    from cslam_tpu_torch.utils.image_sequence import GlobImageSequence
    h = hashlib.sha256()
    n = 0
    for d in sorted(glob.glob(str(REPO / "tests" / "data" / "real_seq*"))):
        seq = GlobImageSequence(os.path.join(d, "image_2"))
        for i in range(len(seq)):
            h.update(np.ascontiguousarray(seq.frame(i), np.uint8).tobytes())
            n += 1
    return {"frames": n, "sha256": h.hexdigest(),
            "equals_pil_12_1_decode": h.hexdigest() == REAL_FRAMES_SHA256}


def fixture_poses(path, n=240):
    """tests/test_eval_artifacts.py's _fixture_poses: a KITTI-format
    figure-8 (revisits -> loop-closure opportunities)."""
    ts, Rs = [], []
    for k in range(n):
        u = 2 * np.pi * k / n
        ts.append([50 * np.sin(2 * u) / 2, 0.3 * np.sin(3 * u),
                   40 * np.sin(u)])
    ts = np.asarray(ts)
    for k in range(n):
        d = ts[min(k + 1, n - 1)] - ts[max(k - 1, 0)]
        d = d / max(np.linalg.norm(d), 1e-9)
        up = np.array([0.0, 1.0, 0.0])
        r = np.cross(up, d)
        r /= max(np.linalg.norm(r), 1e-9)
        Rs.append(np.stack([r, np.cross(d, r), d], axis=1))
    flat = np.concatenate([np.asarray(Rs), ts[:, :, None]],
                          axis=2).reshape(-1, 12)
    np.savetxt(path, flat, fmt="%.9e")


def start_kitti_eval(tmp, extra=()):
    """Start `python -m cslam_tpu_torch.tools.kitti_eval` on the fixture
    poses in a child process; returns (process, JSON path, log path,
    start time) for `finish_kitti_eval`."""
    poses = os.path.join(tmp, "poses.txt")
    if not os.path.exists(poses):
        fixture_poses(poses)
    tag = "cnn" if "--images" in extra else "poses"
    out, log = os.path.join(tmp, f"eval_{tag}.json"), \
        os.path.join(tmp, f"eval_{tag}.log")
    cmd = [sys.executable, "-m", "cslam_tpu_torch.tools.kitti_eval",
           "--data", poses, *KITTI_EVAL, "--out", out, *extra]
    return spawn(cmd, log, dict(os.environ)), out, log, time.perf_counter()


def finish_kitti_eval(run, deadline):
    """Wait for a started kitti_eval until the perf_counter `deadline`
    (past it every process of its group is killed and the phase fails);
    returns its JSON and the process's wall seconds."""
    proc, out, log, t0 = run
    try:
        proc.wait(timeout=max(deadline - time.perf_counter(), 0.1))
    except subprocess.TimeoutExpired:
        kill_group(proc)
        raise AssertionError(f"kitti_eval passed its "
                             f"{KITTI_EVAL_DEADLINE_S} s deadline:\n"
                             f"{log_tail(log)}") from None
    wall_s = time.perf_counter() - t0
    if group_alive(proc):
        kill_group(proc)
        raise AssertionError("kitti_eval left a process behind")
    if proc.returncode != 0:
        raise AssertionError(f"kitti_eval exited {proc.returncode}:\n"
                             f"{log_tail(log)}")
    return dict(json.loads(Path(out).read_text()), process_wall_s=wall_s)


def check_kitti_eval(res, platform="cuda"):
    """The reference test's gates on kitti_eval's JSON, on `platform`
    with the kernel launched when that is the card."""
    launched = sum(res["knn_launches"].values())
    if not (res["platform"] == platform and res["n_robots"] == 4 and
            res["optimizations"] >= 1 and
            res["verified_loop_closures"] >= 1 and
            res["ate_rmse_merged_optimized_m"] is not None and
            res["ate_merged_improvement"] > 1.0 and
            res["gossip_comm_bytes"] > 0 and
            (platform != "cuda" or launched > 0)):
        raise AssertionError(f"kitti_eval gates: {res}")


def run_tooling_phase(card):
    """Phase 16: kitti_eval on the card (the poses, and at the same time
    the CNN path on the real frames, two child processes), the
    real-pixel and TUM gates on the card, and the decode's digest;
    returns its fields."""
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        fixture_poses(os.path.join(tmp, "poses.txt"))
        runs = {"kitti_eval": start_kitti_eval(tmp),
                "kitti_eval_cnn": start_kitti_eval(
                    tmp, ("--images", str(REAL_SEQ), "--model", "shipped"))}
        deadline = time.perf_counter() + KITTI_EVAL_DEADLINE_S
        try:
            for name, run in list(runs.items()):
                fields[name] = finish_kitti_eval(run, deadline)
                check_kitti_eval(fields[name])
                del runs[name]
        finally:
            for proc, *_ in runs.values():
                kill_group(proc)
        t = time.perf_counter()
        fields["real_pixels"] = dict(check_real_pixel_gates(card, tmp),
                                     s=time.perf_counter() - t)
    fields["decode"] = decoded_frames_digest()
    fields["card"] = card
    return fields


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Smoke run of the port "
                                     "on the card(s); see the docstring.")
    parser.add_argument("--only", choices=["multichip", "training",
                                           "tooling", "knn_host",
                                           "lightglue_graph"],
                        default=None,
                        help="run the device and build phases and this "
                             "phase alone (multichip: with the slice, for "
                             "its pose graph)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from cslam_tpu_torch import _build
    from cslam_tpu_torch.device import resolve_device
    from cslam_tpu_torch.ops import knn_pallas as kp
    from cslam_tpu_torch.swarm_slice import candidate_table, ingest, \
        make_params, run_slice
    from cslam_tpu_torch.matching.sparse_matching import \
        LoopClosureSparseMatching

    # 1. device; the port's own device resolution must turn TF32 off
    # for fp32 matrix products and for cuDNN convolutions (PyTorch's
    # default for the latter is on)
    t0 = time.perf_counter()
    resolve_device("cuda")
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    if any(tf32.values()):
        raise AssertionError(f"TF32 must be off after resolve_device: "
                             f"{tf32}")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase("device", t0, card=card, kind=kind, count=count,
          torch=torch.__version__, cuda=torch.version.cuda,
          allow_tf32=tf32)

    # 2. build, and the tensor-core instructions of each kernel
    t0 = time.perf_counter()
    _build.load_library()
    hmma = sass_hmma_counts(_build.library_path())
    # topk_f32 and topk_f32_gemv
    hmma_f32 = sum(n for f, n in hmma.items() if "topk_f32" in f)
    hmma_bf16 = {f: n for f, n in hmma.items() if "topk_bf16_mma" in f}
    phase("build", t0, build_s=_build.build_seconds,
          library=_build.library_path().name, hmma_per_function=hmma)
    if not hmma_bf16 or min(hmma_bf16.values()) == 0:
        raise AssertionError("the bf16 kernel has no HMMA instruction")
    if hmma_f32:
        raise AssertionError("the f32 kernel uses the tensor cores")
    if args.only in ("training", "tooling", "knn_host", "lightglue_graph"):
        t0 = time.perf_counter()
        if args.only == "training":
            phase("training", t0, **run_training_phase("cuda"))
        elif args.only == "tooling":
            phase("tooling", t0, **run_tooling_phase("cuda"))
        elif args.only == "knn_host":
            phase("knn_host", t0, **time_knn_host(card))
        else:
            phase("lightglue_graph", t0, **time_lightglue_graph(card))
        emit({"total_elapsed_s": round(time.perf_counter() - T_START, 3)})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": count}})
        return 0
    if args.only == "multichip":
        t0 = time.perf_counter()
        res = run_slice(4, 1000, descriptor_dim=512, seed=SEED,
                        device="cuda", nns_method="pallas",
                        rounds=SLICE_ROUNDS)
        phase("slice", t0, loop_closures=len(res["loop_closures"]),
              timings_s=res["timings"])
        multichip_phase(kp, card, res, cards_only=count >= 2)
        emit({"total_elapsed_s": round(time.perf_counter() - T_START, 3)})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": count}})
        return 0

    # 3. kernel against plain, then timings
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for n_valid in (1, 7, 513):
        for k in (1, 10):
            cases.append((1024, n_valid, 512, 1, k, torch.float32))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((1024, 5, 512, 3, 10, dtype))   # k > n_valid
        for n_valid, k in ((5000, 65), (5000, 200), (150, 200)):
            cases.append((8192, n_valid, 96, 5, k, dtype))   # k > KMAX
    for batch in (1, 3, 4, 5):                       # f32 B <= 4 variant
        for dim in (33, 96, 1500):
            cases.append((4096, 2001 + 5 * batch, dim, batch, 10,
                          torch.float32))
    for batch in (1, 15, 16, 17, 65, 256):           # tensor-core edges
        for dim in (33, 96, 512):
            cases.append((4096, 3001 + 7 * batch, dim, batch, 10,
                          torch.bfloat16))
    for dim in (64, 128):                  # CosPlace and NetVLAD + PCA
        for dtype in (torch.float32, torch.bfloat16):
            for n_valid in (48, 1000):
                for batch in (1, 64):
                    for k in (1, 10):
                        cases.append((1024, n_valid, dim, batch, k, dtype))
    worst = 0.0
    for c in cases:
        _, err = check_knn_case(kp, *c, gen)
        worst = max(worst, err)
    for dtype in (torch.float32, torch.bfloat16):
        worst = max(worst, check_duplicates(kp, dtype, gen))
    worst = max(worst, check_back_to_back(kp, gen))
    timing = {}
    for label, shape, dtype in (
            ("main_f32", MAIN_SHAPE, torch.float32),
            ("main_bf16", MAIN_SHAPE, torch.bfloat16),
            ("headline_f32", HEADLINE, torch.float32),
            ("headline_bf16", HEADLINE, torch.bfloat16)):
        inputs, err = check_knn_case(kp, shape["n_cap"], shape["n_valid"],
                                     shape["dim"], shape["batch"],
                                     shape["k"], dtype, gen)
        worst = max(worst, err)
        iters = 200 if label.startswith("main") else 50
        timing[label] = timing_row(kp, inputs, shape, dtype, err, iters)
        del inputs
    for label, (shape, dtype) in DESC_SHAPES.items():
        inputs, err = check_knn_case(kp, shape["n_cap"], shape["n_valid"],
                                     shape["dim"], shape["batch"],
                                     shape["k"], dtype, gen)
        worst = max(worst, err)
        timing[label] = timing_row(kp, inputs, shape, dtype, err, 200)
    # the user-level wrapper routes a CUDA tensor to the kernel, one
    # launch per search of k <= KMAX
    before = sum(kp.cosine_topk_pallas.launches.values())
    data = torch.randn((2048, 64), generator=gen, device="cuda")
    kp.cosine_topk_pallas(data, 2000, data[:4], 5)
    if sum(kp.cosine_topk_pallas.launches.values()) != before + 1:
        raise AssertionError("cosine_topk_pallas did not launch the kernel")
    # the small-dense kernel (MAC's warm-LOBPCG) at LOBPCG's shapes
    from cslam_tpu_torch.ops import small_dense as sd
    small_err = check_small_dense(sd, gen)
    small_timing = time_small_dense(sd, gen)
    torch.cuda.empty_cache()
    phase("kernel", t0, cases=len(cases) + 8 + len(DESC_SHAPES),
          max_abs_err=worst,
          timing=timing, small_dense_max_err=small_err,
          small_dense_timing=small_timing, card=card)
    t0 = time.perf_counter()
    phase("knn_host", t0, **time_knn_host(card))

    # 4. the slice at map scale (f32 storage: the f32 kernel)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kp)
    res = run_slice(4, 1000, descriptor_dim=512, seed=SEED, device="cuda",
                    nns_method="pallas", rounds=SLICE_ROUNDS)
    launches = dict(kp.cosine_topk_pallas.launches)
    selected = sum(len(s) for s in res["selected"])
    phase("slice", t0, robots=4, keyframes=4000, descriptor_dim=512,
          candidates=len(res["candidates"]), selected=selected,
          loop_closures=len(res["loop_closures"]),
          verification_failures=res["verification_failures"],
          ate_odom=res["ate_odom"], ate_opt=res["ate_opt"],
          gnc_iters=res["gnc_iters"], timings_s=res["timings"],
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          knn_launches=launches)
    if launches["cosine_topk_f32"] <= 0:
        raise AssertionError("the slice never launched the f32 kernel")
    if not res["ate_opt"] < res["ate_odom"]:
        raise AssertionError(f"optimized ATE {res['ate_opt']} is not below "
                             f"odometry ATE {res['ate_odom']}")
    if not len(res["loop_closures"]) > 0:
        raise AssertionError("no verified loop closures")
    threshold = make_params(0, 4)["frontend.similarity_threshold"]

    # 5. path check: exact search, same descriptors
    t0 = time.perf_counter()
    lcm = LoopClosureSparseMatching(make_params(0, 4, nns_method="exact"),
                                    device="cuda")
    ingest(lcm, res["descriptors"])
    exact = candidate_table(lcm)
    diff = compare_candidates(res["candidates"], exact, threshold)
    phase("path_check", t0, candidates=len(exact), **diff)
    if diff["unexplained"]:
        raise AssertionError("exact search found other candidates")

    # 6. bf16 storage: the main path's own B = 1 searches on the
    # tensor-core kernel, against the plain version and the exact path
    t0 = time.perf_counter()

    def ingest_bf16(method, device):
        params = make_params(0, 4, nns_method=method)
        params["frontend.nns_storage"] = "bfloat16"
        lcm = LoopClosureSparseMatching(params, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ingest(lcm, res["descriptors"])
        torch.cuda.synchronize()
        return candidate_table(lcm), time.perf_counter() - t

    reset_launches(kp)
    kernel_bf16, ingest_s = ingest_bf16("pallas", "cuda")
    launches_bf16 = dict(kp.cosine_topk_pallas.launches)
    plain_bf16, plain_ingest_s = ingest_bf16("pallas", "cpu")
    exact_bf16, exact_ingest_s = ingest_bf16("exact", "cuda")
    vs_plain = compare_candidates(kernel_bf16, plain_bf16, threshold,
                                  tol=1e-4)
    vs_exact = compare_candidates(kernel_bf16, exact_bf16, threshold,
                                  tol=BF16_LOWERINGS_TOL)
    phase("bf16_ingest", t0, candidates=len(kernel_bf16),
          knn_ingest_s=ingest_s, plain_cpu_ingest_s=plain_ingest_s,
          exact_ingest_s=exact_ingest_s, knn_launches=launches_bf16,
          vs_plain=vs_plain, vs_exact=vs_exact)
    if launches_bf16["cosine_topk_bf16_mma"] <= 0:
        raise AssertionError("bf16 ingestion never launched its kernel")
    if vs_plain["unexplained"] or vs_exact["unexplained"]:
        raise AssertionError("bf16 kernel ingestion found other candidates")

    # 7. the mission through SwarmNode (f32 storage: the f32 kernel)
    from cslam_tpu_torch.sim_mission import run_mission
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    faulthandler.dump_traceback_later(MISSION_WATCHDOG_S, exit=True)
    try:
        reset_launches(kp)
        sd_before = dict(sd.LAUNCHES)
        mission = run_mission(**MISSION, seed=SEED, device="cuda")
        mission["knn_launches"] = dict(kp.cosine_topk_pallas.launches)
        # executions: launches outside captures and the replayed ones
        mission["small_dense_launches"] = {
            name: n - sd_before[name] for name, n in sd.LAUNCHES.items()}
        mission["threads_left"] = live_non_daemon_threads()
    finally:
        faulthandler.cancel_dump_traceback_later()
    phase("mission", t0, robots=MISSION["n_robots"],
          keyframes_per_robot=MISSION["n_poses"],
          descriptor_dim=MISSION["descriptor_dim"],
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          card=card, **dict(mission,
                            fixed_edges=len(mission["fixed_edges"])))
    check_mission(mission)

    # 8. keyframe images -> descriptors on the card, config path
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    published, comps, fields = run_descriptor_phase(card)
    phase("descriptor", t0, **fields)

    # 9. place recognition: recall gates and the detector, top-1 from
    # the kernel
    t0 = time.perf_counter()
    reset_launches(kp)
    recog = run_place_recognition(kp, published, comps[0].model)
    launches_pr = recog["knn_launches"]
    phase("place_recognition", t0, **recog)
    check_place_recognition(recog)
    del comps, published

    # 10. the learned visual mission, then card against CPU and the
    # shipped-weight gates on the card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    faulthandler.dump_traceback_later(VISUAL_WATCHDOG_S, exit=True)
    try:
        visual = run_visual_phase(kp, card)
        launches_visual = visual["knn_launches"]
        visual["mission_s"] = time.perf_counter() - t0
        visual["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        visual["card_vs_cpu"] = check_visual_on_card("cuda")
        visual["shipped_weight_gates"] = check_trained_gates("cuda")
        visual["checks_s"] = time.perf_counter() - t
    finally:
        faulthandler.cancel_dump_traceback_later()
    phase("visual", t0, **visual)

    # 11. the visual models' forwards, timed
    t0 = time.perf_counter()
    phase("visual_models", t0, **time_visual_models(card))

    # 12. the lidar mission, then card against CPU and the op timings
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    faulthandler.dump_traceback_later(LIDAR_WATCHDOG_S, exit=True)
    try:
        lidar = run_lidar_phase(kp, card)
        launches_lidar = lidar["knn_launches"]
        lidar["mission_s"] = time.perf_counter() - t0
        lidar["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        lidar["card_vs_cpu"] = check_lidar_on_card("cuda")
        lidar["checks_s"] = time.perf_counter() - t
        lidar["ops"] = time_lidar_ops(card)
    finally:
        faulthandler.cancel_dump_traceback_later()
    phase("lidar", t0, **lidar)
    check_lidar_phase(lidar)

    # 13. a g2o file through the solve_g2o CLI on the card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    g2o = run_g2o_phase(card)
    phase("g2o", t0, **g2o)
    check_g2o_phase(g2o)

    # 14. four launcher robot processes on the card over the TCP bus,
    # one of them killed and resumed from its checkpoint
    t0 = time.perf_counter()
    launch = run_launch_phase(card)
    launches_launcher = {
        name: sum(m["knn_launches"][name]
                  for m in launch["robots"].values())
        for name in kp.cosine_topk_pallas.launches}
    phase("launch", t0, robots=launch_summary(launch),
          events=launch["events"], logger_csvs=launch["logger_csvs"],
          children_left=launch["children_left"],
          knn_launches=launches_launcher, card=card)
    check_launch_phase(launch)

    # 15. the four trainers on the card: step parity against the CPU,
    # their main code paths, checkpoints, homographic adaptation
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    phase("training", t0, **run_training_phase("cuda"))

    # 16. kitti_eval on the card in child processes, the real-pixel and
    # TUM gates on the card
    t0 = time.perf_counter()
    tooling = run_tooling_phase("cuda")
    phase("tooling", t0, **tooling)
    launches_eval = {
        name: sum(tooling[run]["knn_launches"][name]
                  for run in ("kitti_eval", "kitti_eval_cnn"))
        for name in kp.cosine_topk_pallas.launches}

    # 17. the multi-device layer: meshes of ranks on the card(s)
    multi = multichip_phase(kp, card, res)

    def entry(name, main, n_launches):
        return {"name": name, "route": "cuda", "source": KNN_SOURCE,
                "replaces": KNN_REPLACES, "launches": n_launches,
                "max_abs_err": worst, "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "checked": True}

    f32 = entry("cosine_topk_f32", timing["main_f32"],
                launches["cosine_topk_f32"])
    f32["mission_launches"] = mission["knn_launches"]["cosine_topk_f32"]
    bf16 = entry("cosine_topk_bf16_mma", timing["main_bf16"],
                 launches_bf16["cosine_topk_bf16_mma"])
    for e in (f32, bf16):
        e["place_recognition_launches"] = launches_pr[e["name"]]
        e["visual_launches"] = launches_visual[e["name"]]
        e["lidar_launches"] = launches_lidar[e["name"]]
        e["launcher_launches"] = launches_launcher[e["name"]]
        e["kitti_eval_launches"] = launches_eval[e["name"]]
        e["multichip_launches"] = multi["knn_launches"][e["name"]]

    eigh12 = small_timing["eigh_12"]
    small = {"name": "small_dense", "route": "cuda",
             "source": "cslam_tpu_torch/csrc/small_dense.cu",
             "replaces": None,
             "launches": sum(mission["small_dense_launches"].values()),
             "mission_launches": mission["small_dense_launches"],
             "max_abs_err": small_err, "ms": eigh12["ms"],
             "plain_ms": eigh12["plain_ms"], "bound_ms": eigh12["bound_ms"],
             "bound_by": eigh12["bound_by"],
             "library_ms": eigh12["library_ms"], "shape": "eigh 12 x 12",
             "shapes": small_timing, "checked": True}
    emit({"kernels": [f32, bf16, small]})
    emit({"total_elapsed_s": round(time.perf_counter() - T_START, 3)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
