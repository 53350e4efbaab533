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
     headline 100k x 512 / B=256 shape in f32 and bf16, k above one
     pass, ragged batch, depth and n_valid on the tensor-core path,
     duplicate rows, back-to-back searches on one stream), then
     CUDA-event timings of the search, the plain version and a library
     call, and the search's host wall time per call;
  4. slice: the device path at map scale — 4 robots x 1000 keyframes,
     512-d descriptors: kNN ingestion through the f32 kernel, 4 rounds
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
     PGO on a worker thread) at 4 robots x 1000 keyframes, 512-d
     descriptors: per-stage wall seconds, the f32 kernel's launches over
     this phase alone, the protocol's counts, ATE per robot, the host
     time of one to_arrays of the aggregated graph. It runs under a
     watchdog that dumps every thread's stack and exits non-zero if the
     phase stalls, waits on each solve with a timeout, and fails if a
     non-daemon thread outlives it;
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
     launches (0: the lidar path does not search descriptors); then 4
     keyframe pairs' voxel grid, Scan Contexts, FPFH, GNC-ICP and whole
     registration on the card against the CPU, and CUDA-event times of
     one voxel_downsample, fpfh, nearest_neighbors and gnc_icp at
     N = 8192 against their operations / bytes bounds;
then the kernels line, the card line, and the result line.

Exits non-zero, printing no result, without a CUDA card, without the
package, or when any phase fails. Uses no JAX.
"""

import contextlib
import faulthandler
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
SEED = 0
HEADLINE = dict(n_cap=131072, n_valid=100000, dim=512, batch=256, k=10)
# the slice's own search shape: one robot's database after ingestion
# (1000 keyframes in a 1024-row buffer), one query, best match only
MAIN_SHAPE = dict(n_cap=1024, n_valid=1000, dim=512, batch=1, k=1)
# MAC selection rounds of the slice phase: 8 before the visual phases
# came, cut to 4 to keep the script in its time limit (PERF.md §4)
SLICE_ROUNDS = 4
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
KNN_REPLACES = "cslam_tpu/ops/knn_pallas.py:77"
KNN_SOURCE = "cslam_tpu_torch/csrc/cosine_topk.cu"
# exact path vs kernel on bf16 storage: the reference's own bound
# between its two bf16 lowerings (the exact path rounds the raw query to
# bf16, the kernel the normalized one; tests/test_torch_knn.py)
BF16_LOWERINGS_TOL = 5e-3
# the mission phase: the shape of benchmarks/SCALE_MISSION.json, the
# sim mission's settings; a stalled phase is ended by the watchdog
MISSION = dict(n_robots=4, n_poses=1000, descriptor_dim=512)
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
# card against CPU: two revisits of one robot, two across robots
LIDAR_CHECK_PAIRS = (((0, 0), (0, 39)), ((1, 5), (1, 34)),
                     ((0, 20), (1, 10)), ((2, 15), (3, 5)))
# card against CPU: voxel centroids; FPFH values, and the share of rows
# whose 16 neighbours agree; ICP and registration poses
LIDAR_CENTROID_TOL = 1e-6
LIDAR_FPFH_TOL = 1e-4
LIDAR_FPFH_ROWS = 0.995
LIDAR_POSE_TOL = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name, t0, **fields):
    emit({"phase": name, "elapsed_s": round(time.perf_counter() - t0, 3),
          **fields})


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


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
    from cslam_tpu_torch.visual_mission import SquareWorld, make_pose
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
    from cslam_tpu_torch.visual_mission import INTR, make_pose

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
    from cslam_tpu_torch.visual_mission import INTR, make_pose

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


def main():
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
    torch.cuda.empty_cache()
    phase("kernel", t0, cases=len(cases) + 8 + len(DESC_SHAPES),
          max_abs_err=worst,
          timing=timing, card=card)

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
        mission = run_mission(**MISSION, seed=SEED, device="cuda")
        mission["knn_launches"] = dict(kp.cosine_topk_pallas.launches)
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

    emit({"kernels": [f32, bf16]})
    emit({"total_elapsed_s": round(time.perf_counter() - T_START, 3)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
