"""The comparison that decides `correct`.

Each number below compares what the timed path produced with the plain
reference (`reference.py`), in float64, on the recording's own inputs.
A number is computed only where the window produced something for it.
`numbers(run, control=True)` puts the reference's control twin (TF32
inputs, float32) in the program's place and judges it the same way; the
benchmark's own runs never do that.

- topk_err: over a sample of the descriptor searches (best match of a
  query against one robot's database, as it stood at the search), the
  larger of |returned similarity - exact similarity of the returned
  keyframe| and (exact best similarity - exact similarity of the
  returned keyframe).
- selection_faults: over every MAC selection round, selected edges that
  were not candidates at the call, edges selected twice, selections over
  the budget, and empty selections from a non-empty pool. Exact.
- pgo_cost_err: over every solve, the gap between the solver's final
  robust cost (and its initial cost) and the reference's cost of the
  same factors at the returned (and the initial) poses with the returned
  GNC weights, over max(reference cost, number of factors).
- pgo_grad_ratio: over every solve whose graph holds a loop closure, the
  norm of the reference's gradient of the factors' robust cost (the
  returned GNC weights held fixed) over every pose but the one the prior
  anchors, at the returned poses, over its norm at the initial poses,
  both summed over those solves: how far the solves went towards a
  stationary point. A solve that returns its state unchanged reads 1.
  The control holds the returned poses in TF32.
- estimate_mismatch: poses a robot adopted from a shared estimate that
  differ from the poses its solve returned. Exact.

Front-ends add their own numbers through `checks(run, control, rng)`.
"""

import numpy as np

from swarmbench import reference as ref


def topk_err(run, control, rng):
    recs = run.records
    if not recs.searches or not hasattr(run.rec, "descriptor"):
        return None
    take = int(run.cell.traffic.get("check_searches", 3000))
    idx = np.arange(len(recs.searches))
    if len(idx) > take:
        idx = np.sort(rng.choice(idx, take, replace=False))
    unit = {}
    worst = 0.0
    for i in idx:
        p, owner, dbr, n, qr, qk, item, sim = recs.searches[i]
        items = recs.db_items[p, owner, dbr]
        ids = np.array([items[row] for row in range(n)], dtype=np.int64)
        if dbr not in unit:
            unit[dbr] = ref.unit_rows(run.rec.desc[dbr])
        query = run.rec.descriptor(qr, qk)
        exact = unit[dbr][ids] @ ref.unit_rows(query)
        if control:
            row, sim = ref.best_match(run.rec.desc[dbr][ids], query, True)
            item = int(ids[row])
        got = float(exact[np.nonzero(ids == item)[0][0]])
        worst = max(worst, abs(sim - got), float(exact.max()) - got)
    return worst


def selection_faults(run, control, rng):
    rounds = [s for s in run.records.selections if s[2]]
    if not rounds:
        return None
    faults = 0
    for _, budget, pool, sel in rounds:
        pool = set(pool)
        faults += sum(e not in pool for e in sel)
        faults += len(sel) - len(set(sel))
        faults += max(0, len(sel) - budget)
        faults += int(len(sel) == 0)
    return faults


def pgo_cost_err(run, control, rng):
    if not run.records.solves:
        return None
    worst = 0.0
    for s in run.records.solves:
        fg, res = s["fg"], s["result"]
        if res is None or not fg.factors:
            continue
        nf = fg.num_factors
        w = res.weights[:nf].detach().cpu().numpy()
        prior = (fg.prior_R, fg.prior_t, fg.prior_key, fg.prior_weight)
        for R, t, weights, claimed in (
                (fg.R, fg.t, w, float(res.cost)),
                (s["R0"], s["t0"], np.ones(nf), float(res.initial_cost))):
            R, t = np.stack(R), np.stack(t)
            exact = ref.graph_cost(fg.factors, fg.key_to_index, R, t,
                                   weights, prior)
            if control:
                claimed = ref.graph_cost(fg.factors, fg.key_to_index, R, t,
                                         weights, prior, control=True)
            worst = max(worst, abs(claimed - exact) / max(exact, nf))
    return worst


def pgo_grad_ratio(run, control, rng):
    ret = init = 0.0
    found = False
    for s in run.records.solves:
        fg, res = s["fg"], s["result"]
        if res is None or not any(f.is_loop for f in fg.factors):
            continue
        found = True
        w = res.weights[:fg.num_factors].detach().cpu().numpy()
        anchor = fg.key_to_index[fg.prior_key]
        R, t = np.stack(fg.R), np.stack(fg.t)
        if control:
            R, t = ref.tf32(R), ref.tf32(t)
        g = ref.graph_gradient(fg.factors, fg.key_to_index, R, t, w, anchor)
        g0 = ref.graph_gradient(fg.factors, fg.key_to_index,
                                np.stack(s["R0"]), np.stack(s["t0"]), w,
                                anchor)
        ret += float(np.sum(g * g))
        init += float(np.sum(g0 * g0))
    if not found or init <= 0.0:
        return None
    return float(np.sqrt(ret / init))


def estimate_mismatch(run, control, rng):
    recs = run.records
    if not recs.adoptions:
        return None
    bad = 0
    for p, rid, _, poses, n_solves in recs.adoptions:
        solve = None
        for s in reversed(recs.solves[:n_solves]):
            if s["pass"] == p and all(k in s["fg"].key_to_index
                                      for k in poses):
                solve = s
                break
        if solve is None:
            bad += len(poses)
            continue
        fg = solve["fg"]
        for k, (R, t) in poses.items():
            i = fg.key_to_index[k]
            bad += int(not (np.array_equal(R, fg.R[i])
                            and np.array_equal(t, fg.t[i])))
    return bad


CHECKS = (topk_err, selection_faults, pgo_cost_err, pgo_grad_ratio,
          estimate_mismatch)
# numbers whose comparison is exact: their limit is 0
EXACT = ("selection_faults", "estimate_mismatch")


def numbers(run, control=False):
    """{name: value} of every number the window produced something for;
    the sample draws come from the run's seed."""
    rng = np.random.default_rng([int(run.seed), 0xC0DE])
    out = {}
    for check in CHECKS:
        v = check(run, control, rng)
        if v is not None:
            out[check.__name__] = v
    extra = getattr(run.cell.frontend, "checks", None)
    if extra is not None:
        out.update({k: v for k, v in extra(run, control, rng).items()
                    if v is not None})
    return out


def judge(values, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit (exact ones at 0); a number without a limit fails."""
    rows = []
    ok = True
    for name in sorted(values):
        limit = 0 if name in EXACT else limits.get(name)
        v = values[name]
        good = limit is not None and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
