"""Smoke run of the PyTorch/CUDA port (cslam_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own elapsed_s:
  1. device: card name, power limit, count; fp32 matmuls without TF32;
  2. build: the CUDA kernels, compiled with nvcc from the checkout;
  3. kernel: every kernel against its plain PyTorch version on the card
     (the cosine top-k at the slice's own shapes, the headline
     100k x 512 / B=256 shape in f32 and bf16, and ragged edges), then
     CUDA-event timings of kernel, plain version and a library call;
  4. slice: the device path at map scale — 4 robots x 1000 keyframes,
     512-d descriptors: kNN ingestion through the kernel, 8 rounds of
     MAC selection (matrix-free Fiedler path, P = 4096), GNC-LM PGO;
     the kernel's launches are counted over this phase alone;
  5. path check: the same descriptors through the exact (non-kernel)
     search give the same candidate edges and similarities;
then the kernels line, the card line, and the result line.

Exits non-zero, printing no result, without a CUDA card, without the
package, or when any phase fails. Uses no JAX.
"""

import json
import subprocess
import sys
import time

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


def knn_bound_ms(n_valid, dim, batch, k, dtype):
    """Least time for the search on an H100: the bytes it must move
    (valid rows, queries, inv/bias rows, outputs) over HBM bandwidth vs
    its 2*B*n*D operations over the dtype's peak; the larger bounds."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (n_valid * dim * esize + batch * dim * esize + n_valid * 8
              + batch * k * 8)
    flops = 2.0 * batch * n_valid * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_knn_case(kp, n_cap, n_valid, dim, batch, k, dtype, gen):
    """Kernel vs plain version on one case; raises on disagreement.
    Returns (inputs, max_abs_err)."""
    dev = torch.device("cuda")
    data = torch.randn((n_cap, dim), generator=gen, device=dev).to(dtype)
    queries = torch.randn((batch, dim), generator=gen, device=dev)
    inv, bias, q_n = kp.prepare_inputs(data, n_valid, queries)
    idx_k, val_k = kp._launch(data, n_valid, q_n, inv, bias, k)
    idx_p, val_p = kp.cosine_topk_plain(data, n_valid, q_n, inv, bias, k)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err = float((val_k - val_p).abs().max())
    if not err <= tol:
        raise AssertionError(f"sims differ by {err} > {tol} at "
                             f"{n_cap}x{dim} n={n_valid} B={batch} k={k} "
                             f"{dtype}")
    n_eff = min(k, n_valid)
    full = (q_n.float() @ data.float().T) * inv + bias
    got = torch.gather(full, 1, idx_k[:, :n_eff].long())
    slot_err = float((got - val_k[:, :n_eff]).abs().max()) if n_eff else 0.0
    if not slot_err <= tol:
        raise AssertionError(f"kernel index does not carry its sim "
                             f"({slot_err} > {tol})")
    if n_eff:
        srt = torch.sort(idx_k[:, :n_eff], dim=1)[0]
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise AssertionError("duplicate index in a top-k row")
        if bool((idx_k[:, :n_eff] >= n_valid).any()):
            raise AssertionError("kernel returned a padded row")
    if n_eff < k:
        if not (bool((val_k[:, n_eff:] == kp.NEG_LARGE).all())
                and bool((idx_k[:, n_eff:] == 0).all())):
            raise AssertionError("missing slots must hold -3e38 / 0")
    return (data, q_n, inv, bias), max(err, slot_err)


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
    data, q_n, inv, bias = inputs
    ms = cuda_ms(lambda: kp._launch(data, n_valid, q_n, inv, bias, k), iters)
    plain_ms = cuda_ms(
        lambda: kp.cosine_topk_plain(data, n_valid, q_n, inv, bias, k),
        max(iters // 5, 10))
    # library yardstick: one matmul + top-k over the scaled sims
    # (bf16 products on the tensor cores); the port never calls it
    lib_ms = cuda_ms(lambda: torch.topk(
        (q_n @ data.T).float() * inv + bias, k), iters)
    return ms, plain_ms, lib_ms


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

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    phase("build", t0, build_s=_build.build_seconds,
          library=_build.library_path().name)

    # 3. kernel against plain, then timings
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for n_valid in (1, 7, 513):
        for k in (1, 10):
            cases.append((1024, n_valid, 512, 1, k, torch.float32))
    cases.append((1024, 5, 512, 3, 10, torch.float32))   # k > n_valid
    cases.append((1024, 5, 512, 3, 10, torch.bfloat16))
    worst = 0.0
    for c in cases:
        _, err = check_knn_case(kp, *c, gen)
        worst = max(worst, err)
    timing = {}
    for label, shape, dtype in (
            ("main_f32", MAIN_SHAPE, torch.float32),
            ("headline_f32", HEADLINE, torch.float32),
            ("headline_bf16", HEADLINE, torch.bfloat16)):
        inputs, err = check_knn_case(kp, shape["n_cap"], shape["n_valid"],
                                     shape["dim"], shape["batch"],
                                     shape["k"], dtype, gen)
        worst = max(worst, err)
        iters = 200 if label.startswith("main") else 50
        ms, plain_ms, lib_ms = time_knn(kp, inputs, shape["n_valid"],
                                        shape["k"], iters)
        bound, bound_by = knn_bound_ms(shape["n_valid"], shape["dim"],
                                       shape["batch"], shape["k"], dtype)
        timing[label] = {"shape": shape, "dtype": str(dtype),
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": bound,
                         "bound_by": bound_by}
        del inputs
    # the user-level wrapper routes a CUDA tensor to the kernel
    before = kp.cosine_topk_pallas.launches
    data = torch.randn((2048, 64), generator=gen, device="cuda")
    kp.cosine_topk_pallas(data, 2000, data[:4], 5)
    if kp.cosine_topk_pallas.launches != before + 1:
        raise AssertionError("cosine_topk_pallas did not launch the kernel")
    torch.cuda.empty_cache()
    phase("kernel", t0, cases=len(cases) + 3, max_abs_err=worst,
          timing=timing, card=card)

    # 4. the slice at map scale
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kp.cosine_topk_pallas.launches = 0
    res = run_slice(4, 1000, descriptor_dim=512, seed=SEED, device="cuda",
                    nns_method="pallas", rounds=8)
    launches = kp.cosine_topk_pallas.launches
    selected = sum(len(s) for s in res["selected"])
    phase("slice", t0, robots=4, keyframes=4000, descriptor_dim=512,
          candidates=len(res["candidates"]), selected=selected,
          loop_closures=len(res["loop_closures"]),
          verification_failures=res["verification_failures"],
          ate_odom=res["ate_odom"], ate_opt=res["ate_opt"],
          gnc_iters=res["gnc_iters"], timings_s=res["timings"],
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          knn_launches=launches)
    if launches <= 0:
        raise AssertionError("the slice never launched the kNN kernel")
    if not res["ate_opt"] < res["ate_odom"]:
        raise AssertionError(f"optimized ATE {res['ate_opt']} is not below "
                             f"odometry ATE {res['ate_odom']}")
    if not len(res["loop_closures"]) > 0:
        raise AssertionError("no verified loop closures")

    # 5. path check: exact search, same descriptors
    t0 = time.perf_counter()
    lcm = LoopClosureSparseMatching(make_params(0, 4, nns_method="exact"),
                                    device="cuda")
    ingest(lcm, res["descriptors"])
    exact = candidate_table(lcm)
    diff = compare_candidates(res["candidates"], exact,
                              threshold=make_params(0, 4)[
                                  "frontend.similarity_threshold"])
    phase("path_check", t0, candidates=len(exact), **diff)
    if diff["unexplained"]:
        raise AssertionError("exact search found other candidates")

    main = timing["main_f32"]
    emit({"kernels": [{
        "name": "cosine_topk", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/cosine_topk.cu",
        "replaces": KNN_REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "checked": True}]})
    emit({"total_elapsed_s": round(time.perf_counter() - T_START, 3)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
