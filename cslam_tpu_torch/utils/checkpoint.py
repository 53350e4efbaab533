"""Checkpoint/resume of per-robot SLAM state.

Port of cslam_tpu/utils/checkpoint.py on the port's SwarmNode: the same
directory layout, `manifest.json` keys and `.npz` array names, so a
checkpoint written by either package loads in the other. What a robot
needs to rejoin a mission:

- descriptor databases (local + per-neighbor) with item ids;
- candidate-selector bookkeeping (fixed edges, candidates,
  already-considered matches) — the loop-closure state;
- gossip buffers and per-neighbor high-watermarks
  (last_keyframe_sent/received, last_match_sent);
- back-end graph: odometry estimates, local factors, inter-robot loop
  closures, current optimized estimates, origin robot id.

Format: one directory with .npz array blobs + a JSON manifest. No
pickle — everything is arrays and plain JSON. A database's rows live on
its device; they are copied to the host to be written, and `load_node`
puts every restored row on the node's own databases' device, whatever
device wrote the checkpoint.
"""

import json
import os
import shutil

import numpy as np

from cslam_tpu_torch.backend.factor_graph import BetweenFactor
from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.utils.edges import EdgeInterRobot


def _save_descriptor_db(db, path: str):
    n = len(db)
    # f32 on the host: bf16 storage is written as its lossless f32
    # up-cast (npz has no bfloat16), and add_item re-rounds to the
    # database's storage dtype on restore
    data = db.data[:n].float().cpu().numpy() if n else \
        np.zeros((0, db.dim or 0), dtype=np.float32)
    items = np.asarray([db.items[i] for i in range(n)], dtype=np.int64)
    np.savez_compressed(path, data=data, items=items)


def _load_descriptor_db(db, path: str):
    with np.load(path) as blob:
        data = blob["data"]
        items = blob["items"]
    for vec, item in zip(data, items):
        db.add_item(vec, int(item))


def _factor_arrays(factors):
    n = len(factors)
    out = {
        "key_from": np.asarray([f.key_from for f in factors],
                               dtype=np.int64).reshape(n, 2),
        "key_to": np.asarray([f.key_to for f in factors],
                             dtype=np.int64).reshape(n, 2),
        "R": np.stack([f.R for f in factors]) if n else np.zeros((0, 3, 3)),
        "t": np.stack([f.t for f in factors]) if n else np.zeros((0, 3)),
        "sqrt_info": np.stack([f.sqrt_info for f in factors])
        if n else np.zeros((0, 6, 6)),
        "is_loop": np.asarray([f.is_loop for f in factors], dtype=bool),
    }
    return out


def _factors_from_arrays(blob, prefix=""):
    out = []
    n = len(blob[prefix + "is_loop"])
    for i in range(n):
        out.append(
            BetweenFactor(
                tuple(int(v) for v in blob[prefix + "key_from"][i]),
                tuple(int(v) for v in blob[prefix + "key_to"][i]),
                blob[prefix + "R"][i].astype(np.float32),
                blob[prefix + "t"][i].astype(np.float32),
                blob[prefix + "sqrt_info"][i].astype(np.float32),
                bool(blob[prefix + "is_loop"][i])))
    return out


def _poses(store, keys, field):
    if not keys:
        return np.zeros((0, 3, 3) if field == 0 else (0, 3))
    return np.stack([store[k][field] for k in keys])


def save_node(node, folder: str):
    """Checkpoint a SwarmNode (detection + backend) to `folder`."""
    os.makedirs(folder, exist_ok=True)
    det = node.detection
    be = node.backend

    # descriptor databases
    _save_descriptor_db(det.lcm.local_nnsm,
                        os.path.join(folder, "db_local.npz"))
    for rid, db in det.lcm.other_robots_nnsm.items():
        _save_descriptor_db(db, os.path.join(folder, f"db_robot{rid}.npz"))

    # candidate selector
    sel = det.lcm.candidate_selector
    manifest = {
        "robot_id": node.robot_id,
        "origin_robot_id": be.origin_robot_id,
        "nb_inter_robot_matches": det.nb_inter_robot_matches,
        "fixed_edges": [list(e) for e in sel.fixed_edges],
        "candidate_edges": [list(e) for e in sel.candidate_edges.values()],
        "already_considered": [list(k) for k in
                               sel.already_considered_matches],
        "nb_poses": sel.nb_poses,
        "initial_fixed_edge_exists": sel.initial_fixed_edge_exists,
        "watermarks": {
            str(rid): {
                "last_keyframe_sent": mon.last_keyframe_sent,
                "last_keyframe_received": mon.last_keyframe_received,
                "last_match_sent": mon.last_match_sent,
            }
            for rid, mon in
            det.neighbor_manager.neighbors_monitors.items()
        },
        "gossip_descriptor_buffer": sorted(
            det.global_descriptors_buffer.keys()),
        "gossip_match_buffer": {
            str(k): list(v) for k, v in
            det.inter_robot_matches_buffer.items()
        },
    }
    # gossip descriptor payloads
    keys = sorted(det.global_descriptors_buffer.keys())
    if keys:
        np.savez_compressed(
            os.path.join(folder, "gossip_descriptors.npz"),
            keyframe_ids=np.asarray(keys, dtype=np.int64),
            descriptors=np.stack([
                np.asarray(det.global_descriptors_buffer[k].descriptor)
                for k in keys
            ]))

    # back-end graph
    odo_keys = sorted(be.odometry_pose_estimates.keys())
    est_keys = sorted(be.current_pose_estimates.keys())
    graph = {
        "odo_keys": np.asarray(odo_keys, dtype=np.int64).reshape(-1, 2),
        "odo_R": _poses(be.odometry_pose_estimates, odo_keys, 0),
        "odo_t": _poses(be.odometry_pose_estimates, odo_keys, 1),
        "est_keys": np.asarray(est_keys, dtype=np.int64).reshape(-1, 2),
        "est_R": _poses(be.current_pose_estimates, est_keys, 0),
        "est_t": _poses(be.current_pose_estimates, est_keys, 1),
    }
    for name, arr in _factor_arrays(be.local_factors).items():
        graph[f"local_{name}"] = arr
    inter = [f for fl in be.inter_robot_loop_closures.values() for f in fl]
    for name, arr in _factor_arrays(inter).items():
        graph[f"inter_{name}"] = arr
    np.savez_compressed(os.path.join(folder, "graph.npz"), **graph)

    manifest["latest_local_key"] = list(be.latest_local_key) \
        if be.latest_local_key else None
    # written last: load_node trusts only a folder that has it
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def save_node_atomic(node, folder: str):
    """Crash-safe checkpoint: write into a sibling tmp dir, then swap.

    A SIGKILL mid-save must never corrupt the previous checkpoint —
    the swap point is a pair of renames; load_node only trusts a folder
    containing manifest.json (written last inside save_node), so every
    observable state is either the old complete checkpoint or the new
    one."""
    tmp = folder + ".tmp"
    old = folder + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    save_node(node, tmp)
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(folder):
        os.rename(folder, old)
    os.rename(tmp, folder)
    if os.path.exists(old):
        shutil.rmtree(old)


def load_node(node, folder: str):
    """Restore a SwarmNode from a checkpoint folder."""
    det = node.detection
    be = node.backend
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)

    _load_descriptor_db(det.lcm.local_nnsm,
                        os.path.join(folder, "db_local.npz"))
    for rid, db in det.lcm.other_robots_nnsm.items():
        path = os.path.join(folder, f"db_robot{rid}.npz")
        if os.path.exists(path):
            _load_descriptor_db(db, path)

    sel = det.lcm.candidate_selector
    sel.fixed_edges = [EdgeInterRobot(*e) for e in manifest["fixed_edges"]]
    for e in manifest["candidate_edges"]:
        edge = EdgeInterRobot(*e)
        sel.candidate_edges[sel.edge_key(edge)] = edge
    sel.already_considered_matches = {
        tuple(k) for k in manifest["already_considered"]
    }
    sel.nb_poses = {int(k): v for k, v in manifest["nb_poses"].items()}
    sel.initial_fixed_edge_exists = {
        int(k): v for k, v in manifest["initial_fixed_edge_exists"].items()
    }
    for e in sel.fixed_edges:
        sel.update_nb_poses(e)

    for rid_str, wm in manifest["watermarks"].items():
        mon = det.neighbor_manager.neighbors_monitors.get(int(rid_str))
        if mon is not None:
            mon.last_keyframe_sent = wm["last_keyframe_sent"]
            mon.last_keyframe_received = wm["last_keyframe_received"]
            mon.last_match_sent = wm["last_match_sent"]

    gossip_path = os.path.join(folder, "gossip_descriptors.npz")
    if os.path.exists(gossip_path):
        with np.load(gossip_path) as blob:
            for kf_id, desc in zip(blob["keyframe_ids"],
                                   blob["descriptors"]):
                det.global_descriptors_buffer[int(kf_id)] = \
                    msgs.GlobalDescriptor(
                        keyframe_id=int(kf_id), robot_id=node.robot_id,
                        descriptor=desc.astype(np.float32))
    det.nb_inter_robot_matches = manifest["nb_inter_robot_matches"]
    for k_str, e in manifest["gossip_match_buffer"].items():
        det.inter_robot_matches_buffer[int(k_str)] = EdgeInterRobot(*e)

    with np.load(os.path.join(folder, "graph.npz")) as blob:
        for key, R, t in zip(blob["odo_keys"], blob["odo_R"], blob["odo_t"]):
            be.odometry_pose_estimates[tuple(int(v) for v in key)] = (
                R.astype(np.float32), t.astype(np.float32))
        for key, R, t in zip(blob["est_keys"], blob["est_R"], blob["est_t"]):
            be.current_pose_estimates[tuple(int(v) for v in key)] = (
                R.astype(np.float32), t.astype(np.float32))
        be.local_factors = _factors_from_arrays(blob, "local_")
        for f in _factors_from_arrays(blob, "inter_"):
            pair = (min(f.key_from[0], f.key_to[0]),
                    max(f.key_from[0], f.key_to[0]))
            be.inter_robot_loop_closures.setdefault(pair, []).append(f)
            if f.key_from[0] == be.robot_id:
                be.connected_robots.add(f.key_to[0])
            elif f.key_to[0] == be.robot_id:
                be.connected_robots.add(f.key_from[0])

    be.origin_robot_id = manifest["origin_robot_id"]
    if manifest["latest_local_key"] is not None:
        be.latest_local_key = tuple(manifest["latest_local_key"])
        be.latest_local_pose = be.odometry_pose_estimates[
            be.latest_local_key]
