"""Smoke run of the PyTorch/CUDA port (cslam_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own elapsed_s:
  1. device: card name, power limit, count; fp32 matmuls without TF32;
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
     512-d descriptors: kNN ingestion through the f32 kernel, 8 rounds
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
then the kernels line, the card line, and the result line.

Exits non-zero, printing no result, without a CUDA card, without the
package, or when any phase fails. Uses no JAX.
"""

import faulthandler
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

T_START = time.perf_counter()
SEED = 0
HEADLINE = dict(n_cap=131072, n_valid=100000, dim=512, batch=256, k=10)
# the slice's own search shape: one robot's database after ingestion
# (1000 keyframes in a 1024-row buffer), one query, best match only
MAIN_SHAPE = dict(n_cap=1024, n_valid=1000, dim=512, batch=1, k=1)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from cslam_tpu_torch import _build
    from cslam_tpu_torch.ops import knn_pallas as kp
    from cslam_tpu_torch.swarm_slice import candidate_table, ingest, \
        make_params, run_slice
    from cslam_tpu_torch.matching.sparse_matching import \
        LoopClosureSparseMatching

    # 1. device
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls must be off")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase("device", t0, card=card, kind=kind, count=count,
          torch=torch.__version__, cuda=torch.version.cuda,
          allow_tf32=torch.backends.cuda.matmul.allow_tf32)

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
        ms, device_ms, host_ms, plain_ms, lib_ms = time_knn(
            kp, inputs, shape["n_valid"], shape["k"], iters)
        bound, bound_by = knn_bound_ms(shape["n_valid"], shape["dim"],
                                       shape["batch"], shape["k"], dtype)
        timing[label] = {"shape": shape, "dtype": str(dtype),
                         "max_abs_err": err, "ms": ms,
                         "kernel_device_ms": device_ms, "host_ms": host_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound, "bound_by": bound_by}
        del inputs
    # the user-level wrapper routes a CUDA tensor to the kernel, one
    # launch per search of k <= KMAX
    before = sum(kp.cosine_topk_pallas.launches.values())
    data = torch.randn((2048, 64), generator=gen, device="cuda")
    kp.cosine_topk_pallas(data, 2000, data[:4], 5)
    if sum(kp.cosine_topk_pallas.launches.values()) != before + 1:
        raise AssertionError("cosine_topk_pallas did not launch the kernel")
    torch.cuda.empty_cache()
    phase("kernel", t0, cases=len(cases) + 8, max_abs_err=worst,
          timing=timing, card=card)

    # 4. the slice at map scale (f32 storage: the f32 kernel)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kp)
    res = run_slice(4, 1000, descriptor_dim=512, seed=SEED, device="cuda",
                    nns_method="pallas", rounds=8)
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

    emit({"kernels": [
        f32,
        entry("cosine_topk_bf16_mma", timing["main_bf16"],
              launches_bf16["cosine_topk_bf16_mma"])]})
    emit({"total_elapsed_s": round(time.perf_counter() - T_START, 3)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
