"""Decentralized pose-graph optimization: the per-robot back-end state
machine.

Port of cslam_tpu/backend/decentralized_pgo.py, on the port's bus,
wire messages, C++ state machine binding and GNC-LM solver. `device=`
chooses where the solve runs (None = the CUDA card).

Capability parity with the reference DecentralizedPGO
(Swarm-SLAM src/back_end/decentralized_pgo.cpp):

- state machine IDLE -> WAITING_FOR_NEIGHBORS_INFO ->
  POSEGRAPH_COLLECTION -> WAITING_FOR_NEIGHBORS_POSEGRAPHS ->
  START_OPTIMIZATION -> OPTIMIZATION (decentralized_pgo.h:55-63);
- odometry BetweenFactor chain with repeated-delivery guard (:250-296);
- intra/inter loop-closure factor ingestion (:298-367);
- optimizer election by lowest (origin_robot_id, robot_id), requiring
  local odometry (:394-415);
- pose-graph request/response: own odometry values + own-min-id
  inter-robot loop closures + connectivity list (:417-483);
- BFS connectivity over received neighbor connectivity lists (:511-555);
- aggregation with loop-closure dedup and existence checks (:602-681);
- optimization in a single worker thread (std::async equivalent; the
  solver's torch operations release the GIL) with the result collected
  by the state loop (:853-940); `close()` shuts the worker down;
- per-robot estimate extraction and sharing (:712-728);
- waiting timeout back to IDLE (:580-589);
- heartbeats gated by simulated rendezvous (:730-741);
- on-demand g2o dump (:369-377): raises NotImplementedError until
  backend/g2o.py is ported.
"""

import enum
import sys
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.factor_graph import (BetweenFactor, FactorGraph,
                                                  diag_sqrt_info,
                                                  noise_std_of)
from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.comm.rendezvous import SimulatedRendezVous
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.runtime.native import NativeStateMachine
from cslam_tpu_torch.runtime.tracing import span


class OptimizerState(enum.IntEnum):
    IDLE = 0
    WAITING_FOR_NEIGHBORS_INFO = 1
    POSEGRAPH_COLLECTION = 2
    WAITING_FOR_NEIGHBORS_POSEGRAPHS = 3
    START_OPTIMIZATION = 4
    OPTIMIZATION = 5


def _sqrt_info_from_msg(covariance_diag) -> np.ndarray:
    """Per-factor noise from a message's covariance diagonal; falls back
    to the default model when the message carries no covariance (all
    zeros / missing), matching the reference's covariance.front() != 0
    gate (decentralized_pgo.cpp:256-261) and its per-LC noise models
    (:307-312, :343-348)."""
    cov = np.asarray(covariance_diag, dtype=np.float32).reshape(-1)
    if cov.size == 6 and np.all(cov > 0) and np.all(np.isfinite(cov)):
        return diag_sqrt_info(np.sqrt(cov))
    return diag_sqrt_info(DEFAULT_NOISE_STD)


DEFAULT_NOISE_STD = np.array([0.01, 0.01, 0.01, 0.1, 0.1, 0.1],
                             dtype=np.float32)  # [omega, v]

Pose = Tuple[np.ndarray, np.ndarray]


def _identity() -> Pose:
    return (np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32))


def _between(a: Pose, b: Pose) -> Pose:
    Rr = a[0].T @ b[0]
    tr = a[0].T @ (b[1] - a[1])
    return (Rr.astype(np.float32), tr.astype(np.float32))


class DecentralizedPGO:

    def __init__(self, params: Dict, bus, clock, logger=None,
                 pgo_config: Optional[pgo.PGOConfig] = None, solver=None,
                 device: DeviceLike = None):
        # solver: callable (FactorGraph, PGOConfig) -> PGOResult that
        # also writes estimates back into the graph. Default is the
        # single-device pgo.optimize on `device`.
        self.device = resolve_device(device)
        self.solver = solver or self._solve_on_device
        self.params = params
        self.bus = bus
        self.clock = clock
        self.logger = logger
        self.robot_id = params["robot_id"]
        self.max_nb_robots = params["max_nb_robots"]
        self.origin_robot_id = self.robot_id
        self.pgo_config = pgo_config or pgo.PGOConfig()
        # State transitions + elections live in the C++ core
        # (native/swarm_state.cpp), matching the reference's C++
        # DecentralizedPGO control plane; this class feeds it events.
        self._sm = NativeStateMachine(
            self.robot_id, params.get("backend.max_waiting_time_sec", 60.0))
        self._max_waiting_time_sec = params.get(
            "backend.max_waiting_time_sec", 60.0)

        # local graph state
        self.odometry_pose_estimates: Dict[Tuple[int, int], Pose] = {}
        self.current_pose_estimates: Dict[Tuple[int, int], Pose] = {}
        # full-graph values of the last successful solve, keyed like the
        # factor graph — the warm-start init source (_apply_warm_start)
        self.last_optimized_values: Dict[Tuple[int, int], Pose] = {}
        self.local_factors: List[BetweenFactor] = []
        self.inter_robot_loop_closures: Dict[Tuple[int, int],
                                             List[BetweenFactor]] = {}
        self.connected_robots: Set[int] = set()
        self.latest_local_key: Optional[Tuple[int, int]] = None
        self.latest_local_pose: Pose = _identity()
        self.first_pose: Pose = _identity()
        self.tentative_local_pose_at_latest_optimization: Pose = _identity()
        self.local_pose_at_latest_optimization: Pose = _identity()
        self.latest_optimized_pose: Pose = _identity()
        self.origin_to_first_pose: Pose = _identity()

        # collection state
        self.current_neighbors = msgs.RobotIdsAndOrigin()
        self.received_pose_graphs: Dict[int, msgs.PoseGraph] = {}
        self.received_connectivity: Dict[int, List[int]] = {}
        self.optimization_count = 0
        self.optimization_walls = []  # per-solve {"wall_s", "n_factors"}

        self._executor = ThreadPoolExecutor(max_workers=1)
        self._optimization_future: Optional[Future] = None

        # fault injection
        rendezvous_enabled = params.get(
            "evaluation.enable_simulated_rendezvous", False)
        self.sim_rdv = SimulatedRendezVous(
            clock, params.get("evaluation.rendezvous_schedule_file", ""),
            self.robot_id, rendezvous_enabled)

        # pub/sub wiring
        bus.subscribe("cslam/keyframe_odom", self.odometry_callback)
        bus.subscribe("cslam/intra_robot_loop_closure",
                      self.intra_robot_loop_closure_callback)
        bus.subscribe("/cslam/inter_robot_loop_closure",
                      self.inter_robot_loop_closure_callback)
        bus.subscribe("cslam/current_neighbors",
                      self.current_neighbors_callback)
        bus.subscribe("cslam/get_pose_graph", self.get_pose_graph_callback)
        bus.subscribe("/cslam/pose_graph", self.pose_graph_callback)
        bus.subscribe("cslam/optimized_estimates",
                      self.optimized_estimates_callback)
        bus.subscribe("cslam/print_current_estimates",
                      self.write_current_estimates_callback)
        self.get_current_neighbors_publisher = bus.create_publisher(
            "cslam/get_current_neighbors")
        self.pose_graph_publisher = bus.create_publisher("/cslam/pose_graph")
        self.heartbeat_publisher = bus.create_publisher("cslam/heartbeat")
        self.reference_frames_publisher = bus.create_publisher(
            "/cslam/reference_frames")
        self.get_pose_graph_publishers = {
            i: bus.create_publisher(f"/r{i}/cslam/get_pose_graph")
            for i in range(self.max_nb_robots)
        }
        self.optimized_estimates_publishers = {
            i: bus.create_publisher(f"/r{i}/cslam/optimized_estimates")
            for i in range(self.max_nb_robots)
        }

    def _solve_on_device(self, fg: FactorGraph, cfg: pgo.PGOConfig):
        return pgo.optimize(fg, cfg, device=self.device)

    def close(self):
        """Wait for a running solve, stop the worker thread and free the
        state machine."""
        self._executor.shutdown(wait=True)
        self._sm.close()

    # ------------------------------------------------------------------
    # Factor ingestion
    # ------------------------------------------------------------------
    def odometry_callback(self, msg: msgs.KeyframeOdom):
        """Odometry chain BetweenFactors (reference :250-296)."""
        key = (self.robot_id, msg.id)
        if key == self.latest_local_key:
            return  # repeated-delivery guard (:264-267)
        pose = (np.asarray(msg.pose[0], dtype=np.float32),
                np.asarray(msg.pose[1], dtype=np.float32))
        self.odometry_pose_estimates[key] = pose
        if msg.id == 0:
            self.first_pose = pose
            self.current_pose_estimates[key] = pose
        if self.latest_local_key is not None:
            diff = _between(self.latest_local_pose, pose)
            self.local_factors.append(
                BetweenFactor(self.latest_local_key, key, diff[0], diff[1],
                              _sqrt_info_from_msg(
                                  getattr(msg, "covariance_diag", None))))
        if self.params.get("evaluation.enable_gps_recording", False) and \
                self.logger is not None and hasattr(msg, "gps"):
            gps = np.asarray(msg.gps)
            if gps.size >= 3:
                self.logger.log_gps(msg.id, float(gps[0]), float(gps[1]),
                                    float(gps[2]))
        self.latest_local_pose = pose
        self.latest_local_key = key

    def intra_robot_loop_closure_callback(self,
                                          msg: msgs.IntraRobotLoopClosure):
        if not msg.success:
            return
        self.local_factors.append(
            BetweenFactor((self.robot_id, msg.keyframe0_id),
                          (self.robot_id, msg.keyframe1_id),
                          np.asarray(msg.pose[0], dtype=np.float32),
                          np.asarray(msg.pose[1], dtype=np.float32),
                          _sqrt_info_from_msg(
                              getattr(msg, "covariance_diag", None)),
                          is_loop=True))

    def inter_robot_loop_closure_callback(self,
                                          msg: msgs.InterRobotLoopClosure):
        if not msg.success:
            return
        factor = BetweenFactor((msg.robot0_id, msg.robot0_keyframe_id),
                               (msg.robot1_id, msg.robot1_keyframe_id),
                               np.asarray(msg.pose[0], dtype=np.float32),
                               np.asarray(msg.pose[1], dtype=np.float32),
                               _sqrt_info_from_msg(
                                   getattr(msg, "covariance_diag", None)),
                               is_loop=True)
        pair = (min(msg.robot0_id, msg.robot1_id),
                max(msg.robot0_id, msg.robot1_id))
        self.inter_robot_loop_closures.setdefault(pair, []).append(factor)
        if msg.robot0_id == self.robot_id:
            self.connected_robots.add(msg.robot1_id)
        elif msg.robot1_id == self.robot_id:
            self.connected_robots.add(msg.robot0_id)

    # ------------------------------------------------------------------
    # Election + collection (decisions delegated to the C++ core)
    # ------------------------------------------------------------------
    @property
    def optimizer_state(self) -> OptimizerState:
        return OptimizerState(self._sm.state)

    @optimizer_state.setter
    def optimizer_state(self, state):
        self._sm.force(int(state))

    @property
    def max_waiting_time_sec(self) -> float:
        return self._max_waiting_time_sec

    @max_waiting_time_sec.setter
    def max_waiting_time_sec(self, seconds: float):
        self._max_waiting_time_sec = seconds
        self._sm.set_max_waiting(seconds)

    def _sync_sm(self):
        self._sm.set_origin(self.origin_robot_id)
        self._sm.set_has_odometry(bool(self.odometry_pose_estimates))
        self._sm.set_neighbors(list(self.current_neighbors.ids),
                               list(self.current_neighbors.origins))

    def is_optimizer(self) -> bool:
        """Lowest (origin, id) among neighbors, requiring odometry
        (reference :394-415; native/swarm_state.cpp)."""
        self._sync_sm()
        return self._sm.is_optimizer()

    def current_neighbors_callback(self, msg: msgs.RobotIdsAndOrigin):
        self.current_neighbors = msg
        self._sync_sm()
        self._sm.on_neighbors(list(msg.ids), list(msg.origins))

    def fill_pose_graph_msg(self, robot_ids: List[int]) -> msgs.PoseGraph:
        """Own odometry values + local factors + own-min-id inter-robot
        loop closures among robot_ids (reference :417-475)."""
        values = [
            msgs.PoseGraphValue(robot_id=k[0], keyframe_id=k[1], pose=p)
            for k, p in self.odometry_pose_estimates.items()
        ]
        factors = list(self.local_factors)
        connected: Set[int] = set()
        ids = list(robot_ids)
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                lo, hi = min(ids[i], ids[j]), max(ids[i], ids[j])
                lcs = self.inter_robot_loop_closures.get((lo, hi), [])
                if lcs and (lo == self.robot_id or hi == self.robot_id):
                    connected.update((lo, hi))
                    if lo == self.robot_id:
                        factors.extend(lcs)
        edges = [
            msgs.PoseGraphEdge(
                key_from=f.key_from, key_to=f.key_to,
                measurement=(f.R, f.t),
                noise_std=noise_std_of(f.sqrt_info)) for f in factors
        ]
        return msgs.PoseGraph(
            robot_id=self.robot_id, origin_robot_id=self.origin_robot_id,
            values=values, edges=edges,
            connected_robots=sorted(r for r in connected
                                    if r != self.robot_id))

    def get_pose_graph_callback(self, msg: msgs.RobotIds):
        out = self.fill_pose_graph_msg(list(msg.ids))
        self.pose_graph_publisher.publish(out)
        self.tentative_local_pose_at_latest_optimization = \
            self.latest_local_pose

    def pose_graph_callback(self, msg: msgs.PoseGraph):
        if self.optimizer_state != \
                OptimizerState.WAITING_FOR_NEIGHBORS_POSEGRAPHS:
            return
        self.received_pose_graphs[msg.robot_id] = msg
        self.received_connectivity[msg.robot_id] = list(msg.connected_robots)
        if self.logger is not None:
            self.logger.add_pose_graph_log_info(msg)
        # completeness check + transition handled by the C++ core
        self._sm.on_pose_graph(msg.robot_id)

    def check_received_pose_graphs(self) -> bool:
        return all(rid in self.received_pose_graphs
                   for rid in self.current_neighbors.ids)

    def connected_robot_pose_graph(self) -> Dict[int, bool]:
        """BFS over received connectivity lists (reference :511-555)."""
        connectivity = dict(self.received_connectivity)
        if self.connected_robots:
            connectivity[self.robot_id] = sorted(self.connected_robots)
        is_connected = {self.robot_id: True}
        for rid in self.current_neighbors.ids:
            is_connected.setdefault(rid, False)
        visited = {self.robot_id}
        queue = [self.robot_id]
        while queue:
            current = queue.pop(0)
            for rid in connectivity.get(current, []):
                is_connected[rid] = True
                if rid not in visited:
                    visited.add(rid)
                    queue.append(rid)
        return is_connected

    # ------------------------------------------------------------------
    # Aggregation + optimization
    # ------------------------------------------------------------------
    def aggregate_pose_graphs(self) -> FactorGraph:
        """Merge own + received graphs, dedup loop closures, keep only
        factors whose endpoints exist (reference :602-681)."""
        is_connected = self.connected_robot_pose_graph()
        fg = FactorGraph()
        for key, pose in self.odometry_pose_estimates.items():
            fg.add_node(key, pose[0], pose[1])
        self.tentative_local_pose_at_latest_optimization = \
            self.latest_local_pose
        for rid in self.current_neighbors.ids:
            if is_connected.get(rid, False) and \
                    rid in self.received_pose_graphs:
                for v in self.received_pose_graphs[rid].values:
                    fg.add_node((v.robot_id, v.keyframe_id), v.pose[0],
                                v.pose[1])
        existing = set(fg.key_to_index.keys())
        added: Set[Tuple[Tuple[int, int], Tuple[int, int]]] = set()

        def try_add(factor: BetweenFactor):
            key = (factor.key_from, factor.key_to)
            if factor.key_from in existing and factor.key_to in existing:
                if factor.is_loop and key in added:
                    return
                if factor.is_loop:
                    added.add(key)
                fg.add_between(factor)

        for f in self.local_factors:
            try_add(f)
        ids = list(self.current_neighbors.ids) + [self.robot_id]
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                if is_connected.get(ids[i], False) and \
                        is_connected.get(ids[j], False):
                    lo, hi = min(ids[i], ids[j]), max(ids[i], ids[j])
                    for f in self.inter_robot_loop_closures.get((lo, hi), []):
                        try_add(f)
        for rid in self.current_neighbors.ids:
            if rid not in self.received_pose_graphs:
                continue
            for e in self.received_pose_graphs[rid].edges:
                r0, r1 = e.key_from[0], e.key_to[0]
                if is_connected.get(r0, False) and is_connected.get(r1, False):
                    try_add(
                        BetweenFactor(tuple(e.key_from), tuple(e.key_to),
                                      np.asarray(e.measurement[0]),
                                      np.asarray(e.measurement[1]),
                                      diag_sqrt_info(e.noise_std),
                                      is_loop=(e.key_from[0] != e.key_to[0]
                                               or abs(e.key_from[1] -
                                                      e.key_to[1]) != 1)))
        return fg

    def _optimize(self, fg: FactorGraph):
        """The solve (reference optimize(), :853-886) — GNC-LM."""
        import time as time_
        if self.logger is not None:
            self.logger.start_timer()
        t_start = time_.perf_counter()
        try:
            with span("pgo_solve", robot=self.robot_id,
                      n_factors=fg.num_factors):
                result = self.solver(fg, self.pgo_config)
            # per-solve wall + size record (reference latest_pgo_time,
            # logger.cpp:59-69; read by sim_mission.run_mission)
            self.optimization_walls.append(
                {"wall_s": time_.perf_counter() - t_start,
                 "n_factors": int(fg.num_factors)})
        except Exception:
            # A failed solve must be observable, not a silent return to
            # IDLE — mirror the reference's error logging.
            import traceback
            traceback.print_exc(file=sys.stderr)
            if self.logger is not None:
                self.logger.log_info("pgo_failures", 1.0)
            result = None
        if self.logger is not None:
            self.logger.stop_timer()
            if result is not None:
                self.logger.log_optimized_global_pose_graph(
                    fg, float(result.cost), self.robot_id)
                self._log_loop_closure_errors(fg)
        return fg, result

    def _log_loop_closure_errors(self, fg: FactorGraph):
        """Post-optimization per-loop-closure and total errors (the
        reference Logger's graph-error CSV fields, logger.cpp:137-151)."""
        g = fg.to_arrays(device=self.device)
        r = pgo.edge_residuals(g, g.R, g.t).cpu().numpy()
        u = 0.5 * np.sum(r ** 2, axis=1)
        is_loop = g.is_loop.cpu().numpy() > 0
        mask = g.edge_mask.cpu().numpy() > 0
        self.logger.log_info("total_graph_error", float(u[mask].sum()))
        loop_errors = u[mask & is_loop]
        self.logger.log_info("nb_loop_closures", int((mask & is_loop).sum()))
        if len(loop_errors):
            self.logger.log_info("max_loop_closure_error",
                                 float(loop_errors.max()))
            self.logger.log_info("mean_loop_closure_error",
                                 float(loop_errors.mean()))

    def _apply_warm_start(self, fg: FactorGraph):
        """Initialize the solve from the previous optimization's values.

        The reference re-solves from raw odometry every round
        (aggregate_pose_graphs fills Values from odometry,
        decentralized_pgo.cpp:602-681). In mission steady state the graph
        changes only by a few keyframes/loop closures per round, so the
        previous solution is a near-optimal init: poses seen last round
        keep their optimized values; NEW poses chain the current
        odometry delta off the nearest preceding warm pose of the same
        robot (init = warm_anchor o (odom_anchor^-1 o odom_new)), so the
        init stays continuous across the seam. Only the initialization
        changes — factors, GNC weights, and convergence gates are
        untouched, and LM falls back gracefully if the stored solution
        is stale (it is only an init). Disable with
        backend.warm_start_optimization: false."""
        warm = self.last_optimized_values
        if not warm:
            return
        by_robot: Dict[int, list] = {}
        for key in fg.key_to_index:
            by_robot.setdefault(key[0], []).append(key)
        for keys in by_robot.values():
            keys.sort()
            anchor = None  # ((R_odom, t_odom), (R_warm, t_warm)) at key
            for key in keys:
                idx = fg.key_to_index[key]
                odom = (fg.R[idx].copy(), fg.t[idx].copy())
                if key in warm:
                    fg.add_node(key, *warm[key])
                    anchor = (odom, warm[key])
                elif anchor is not None:
                    (Ro, to), (Rw, tw) = anchor
                    Rrel = Ro.T @ odom[0]
                    trel = Ro.T @ (odom[1] - to)
                    fg.add_node(key, Rw @ Rrel, Rw @ trel + tw)

    def start_optimization(self):
        fg = self.aggregate_pose_graphs()
        first_key = (self.robot_id, 0)
        if first_key not in self.current_pose_estimates:
            return
        if self.params.get("backend.warm_start_optimization", True):
            self._apply_warm_start(fg)
        R0, t0 = self.current_pose_estimates[first_key]
        fg.set_prior(first_key, R0, t0)
        if self.logger is not None:
            self.logger.log_initial_global_pose_graph(fg)
        self._optimization_future = self._executor.submit(self._optimize, fg)
        self._sm.on_optimization_started()

    def check_result_and_finish_optimization(self):
        if self._optimization_future is None:
            self._sm.on_optimization_done()
            return
        if not self._optimization_future.done():
            return
        fg, result = self._optimization_future.result()
        self._optimization_future = None
        self.optimization_count += 1
        if result is not None:
            # full-graph snapshot for next round's warm start (the solver
            # wrote the optimized estimates back into fg)
            self.last_optimized_values = {
                key: (fg.R[idx].copy(), fg.t[idx].copy())
                for key, idx in fg.key_to_index.items()
            }
            self.share_optimized_estimates(fg)
        self._sm.on_optimization_done()

    def share_optimized_estimates(self, fg: FactorGraph):
        """Per-robot estimate extraction (reference :712-728)."""
        ids = list(self.current_neighbors.ids) + [self.robot_id]
        for rid in ids:
            estimates = fg.estimates_for_robot(rid)
            msg = msgs.OptimizationResult(
                success=True, origin_robot_id=self.origin_robot_id,
                estimates=[
                    msgs.PoseGraphValue(robot_id=k[0], keyframe_id=k[1],
                                        pose=(R, t))
                    for k, (R, t) in sorted(estimates.items())
                ])
            self.optimized_estimates_publishers[rid].publish(msg)

    def optimized_estimates_callback(self, msg: msgs.OptimizationResult):
        """Adopt shared estimates + origin (reference :683-710)."""
        if not self.odometry_pose_estimates or not msg.estimates:
            return
        self.current_pose_estimates = {
            (v.robot_id, v.keyframe_id):
            (np.asarray(v.pose[0]), np.asarray(v.pose[1]))
            for v in msg.estimates
        }
        self.origin_robot_id = msg.origin_robot_id
        self.local_pose_at_latest_optimization = \
            self.tentative_local_pose_at_latest_optimization
        latest = max((k for k in self.current_pose_estimates
                      if k[0] == self.robot_id), default=None)
        if latest is not None:
            self.latest_optimized_pose = self.current_pose_estimates[latest]
        first_key = (self.robot_id, 0)
        first_pose = self.current_pose_estimates.get(first_key, _identity())
        self.update_transform_to_origin(first_pose)
        if self.logger is not None:
            self.logger.write_logs()

    def update_transform_to_origin(self, first_pose: Pose):
        """origin -> first-keyframe reference frame; published
        immediately so consumers get the new frame on each optimization
        (the reference's transient-local reference_frame_per_robot
        publisher, decentralized_pgo.cpp:778-805)."""
        self.origin_to_first_pose = first_pose
        self.broadcast_tf_callback()

    def broadcast_tf_callback(self):
        """Publish the full reference-frame chain for other components
        and viewers (reference broadcast_tf_callback, :807-851):
        origin map -> robot map -> latest optimized -> current."""
        if not self.params.get("backend.enable_broadcast_tf_frames", True):
            return
        delta = _between(self.local_pose_at_latest_optimization,
                         self.latest_local_pose)
        self.reference_frames_publisher.publish(msgs.ReferenceFrames(
            robot_id=self.robot_id,
            origin_robot_id=self.origin_robot_id,
            origin_to_first=self.origin_to_first_pose,
            latest_optimized=self.latest_optimized_pose,
            odom_delta=delta,
            current_in_origin=self.current_pose_in_origin_frame()))

    def current_pose_in_origin_frame(self) -> Pose:
        """latest optimized pose composed with odometry since the
        optimization (the reference's TF chain map -> latest optimized ->
        current odometry delta, :807-851)."""
        delta = _between(self.local_pose_at_latest_optimization,
                         self.latest_local_pose)
        R = self.latest_optimized_pose[0] @ delta[0]
        t = self.latest_optimized_pose[0] @ delta[1] + \
            self.latest_optimized_pose[1]
        return (R, t)

    # ------------------------------------------------------------------
    # Timers / state loop (transitions in the C++ core)
    # ------------------------------------------------------------------
    def start_waiting(self):
        self._sm.start_waiting(self.clock.now())

    def end_waiting(self):
        self._sm.end_waiting()

    def check_waiting_timeout(self):
        self._sm.check_timeout(self.clock.now())

    def reinitialize_received_pose_graphs(self):
        self.received_pose_graphs = {}
        self.received_connectivity = {}

    def optimization_callback(self):
        """Start-period tick (reference :591-599)."""
        if self.optimizer_state == OptimizerState.IDLE and \
                self.odometry_pose_estimates:
            self.reinitialize_received_pose_graphs()
            self.get_current_neighbors_publisher.publish(b"")
            self._sm.start_waiting(self.clock.now())

    def optimization_loop_callback(self):
        """Loop-period tick (reference :943-985)."""
        if not self.odometry_pose_estimates:
            return
        self._sync_sm()
        state = self.optimizer_state
        if state == OptimizerState.POSEGRAPH_COLLECTION:
            if len(self.current_neighbors.ids) > 0:
                ids = list(self.current_neighbors.ids) + [self.robot_id]
                for rid in self.current_neighbors.ids:
                    self.get_pose_graph_publishers[rid].publish(
                        msgs.RobotIds(ids=ids))
            self._sm.on_collection_tick(self.clock.now())
        elif state == OptimizerState.START_OPTIMIZATION:
            self.start_optimization()
        elif state == OptimizerState.OPTIMIZATION:
            self.check_result_and_finish_optimization()
        elif self._sm.is_waiting():
            self._sm.check_timeout(self.clock.now())

    def heartbeat_timer_callback(self):
        """Heartbeat gated by rendezvous (reference :730-741)."""
        if not self.sim_rdv.is_alive():
            return
        self.heartbeat_publisher.publish(
            msgs.Heartbeat(origin_robot_id=self.origin_robot_id))

    def visualization_callback(self):
        """Publish the current estimates + known loop closures for
        external viewers (reference visualization_callback,
        decentralized_pgo.cpp:744-776; periodic when
        visualization.enable)."""
        values = [
            msgs.PoseGraphValue(robot_id=k[0], keyframe_id=k[1], pose=p)
            for k, p in sorted(self.current_pose_estimates.items())
        ]
        factors = list(self.local_factors)
        for lcs in self.inter_robot_loop_closures.values():
            factors.extend(lcs)
        edges = [
            msgs.PoseGraphEdge(key_from=f.key_from, key_to=f.key_to,
                               measurement=(f.R, f.t),
                               noise_std=noise_std_of(f.sqrt_info))
            for f in factors
        ]
        self.bus.publish(
            "/cslam/viz/pose_graph",
            msgs.PoseGraph(robot_id=self.robot_id,
                           origin_robot_id=self.origin_robot_id,
                           values=values, edges=edges))

    def write_current_estimates_callback(self, msg):
        raise NotImplementedError(
            "writing the estimates as g2o needs backend/g2o.py, which is "
            "not ported yet")
