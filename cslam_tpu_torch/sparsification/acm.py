"""Algebraic-connectivity maximization: multi-robot candidate bookkeeping.

Port of cslam_tpu/sparsification/acm.py: numpy bookkeeping around the
port's MAC solver (which runs on `device`), with the reference's exact
semantics (cslam/algebraic_connectivity_maximization.py):

- candidate edges deduplicated by canonical key, keeping max weight
  (add_match, :558-571);
- candidate -> fixed migration on successful verification; failed or
  selected candidates are never reconsidered (already_considered_matches,
  :177-202);
- per-robot pose counts inferred from max keyframe id (+1) (:109-118);
- robots out of range or with no connecting edge are excluded; remaining
  robots' keyframes are rekeyed into one contiguous graph via offsets
  (:290-334);
- odometry chain edges synthesized from pose counts alone (:347-361);
- greedy / pseudo-greedy / random / connection-biased initializations
  (:204-288);
- MAC invoked only when sparsification is enabled and an initial fixed
  inter-robot edge exists for every included robot; otherwise
  connection-biased greedy selection (:512-523);
- DisconnectedGraphError retries with increasingly random init (:449-464).

Known reference defects NOT copied (SURVEY.md §7): greedy initialization
with a zero budget selects nothing here (the reference's argpartition
slice [-0:] selects everything).

The below-floor backfill in select_candidates mirrors cslam_tpu
exactly, quirk included: the shortfall is computed on the pool before
rekeying, so candidates touching excluded robots count toward it and are
then dropped by rekey_edges.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.sparsification.mac import MAC, DisconnectedGraphError
from cslam_tpu_torch.utils.edges import (Edge, EdgeInterRobot, edge_key,
                                         replace_weight)


class AlgebraicConnectivityMaximization:

    def __init__(self,
                 robot_id: int = 0,
                 max_nb_robots: int = 1,
                 max_iters: int = 20,
                 fixed_weight: float = 1.0,
                 extra_params: Optional[Dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fixed_weight = fixed_weight
        self.params = extra_params if extra_params is not None else {
            "frontend.enable_sparsification": True,
            "evaluation.enable_sparsification_comparison": False,
        }

        self.fixed_edges: List[EdgeInterRobot] = []
        self.candidate_edges: Dict[tuple, EdgeInterRobot] = {}
        self.already_considered_matches = set()

        self.max_iters = max_iters
        self.max_nb_robots = max_nb_robots
        self.robot_id = robot_id
        self.total_nb_poses = 0

        self.nb_poses = {i: 0 for i in range(max_nb_robots)}
        self.initial_fixed_edge_exists = {
            i: False for i in range(max_nb_robots)
        }
        self.offsets = {i: 0 for i in range(max_nb_robots)}

        self.log_greedy_edges: List[EdgeInterRobot] = []
        self.log_mac_edges: List[EdgeInterRobot] = []
        self._rng = np.random.default_rng()

    # ------------------------------------------------------------------
    # Graph bookkeeping
    # ------------------------------------------------------------------
    def edge_key(self, edge: EdgeInterRobot):
        return edge_key(edge)

    def replace_weight(self, edge, weight):
        return replace_weight(edge, weight)

    def update_nb_poses(self, edge: EdgeInterRobot):
        """Pose count per robot = max known keyframe id + 1."""
        self.nb_poses[edge.robot0_id] = max(self.nb_poses[edge.robot0_id],
                                            edge.robot0_keyframe_id + 1)
        self.nb_poses[edge.robot1_id] = max(self.nb_poses[edge.robot1_id],
                                            edge.robot1_keyframe_id + 1)

    def update_initial_fixed_edge_exists(self, fixed_edge: EdgeInterRobot):
        if fixed_edge.robot0_id != fixed_edge.robot1_id:
            self.initial_fixed_edge_exists[fixed_edge.robot0_id] = True
            self.initial_fixed_edge_exists[fixed_edge.robot1_id] = True

    def set_graph(self, fixed_edges: Sequence[EdgeInterRobot],
                  candidate_edges: Sequence[EdgeInterRobot]):
        self.fixed_edges = list(fixed_edges)
        for e in self.fixed_edges:
            self.update_nb_poses(e)
            self.update_initial_fixed_edge_exists(e)
        for e in candidate_edges:
            self.update_nb_poses(e)
        for e in candidate_edges:
            self.candidate_edges[self.edge_key(e)] = e

    def add_fixed_edge(self, edge: EdgeInterRobot):
        self.fixed_edges.append(edge)
        self.update_nb_poses(edge)
        self.update_initial_fixed_edge_exists(edge)

    def add_candidate_edge(self, edge: EdgeInterRobot):
        if self.edge_key(edge) in self.already_considered_matches:
            return
        self.candidate_edges[self.edge_key(edge)] = edge
        self.update_nb_poses(edge)

    def remove_candidate_edges(self, edges: Sequence[EdgeInterRobot],
                               failed: bool = False):
        for k in list(self.candidate_edges.keys()):
            if self.candidate_edges[k] in edges:
                del self.candidate_edges[k]
        for edge in edges:
            self.already_considered_matches.add(self.edge_key(edge))

    def candidate_edges_to_fixed(self, edges: Sequence[EdgeInterRobot]):
        edges = [self.replace_weight(e, self.fixed_weight) for e in edges]
        for e in edges:
            self.update_initial_fixed_edge_exists(e)
        self.fixed_edges.extend(edges)
        self.remove_candidate_edges(edges)

    def add_match(self, match: EdgeInterRobot):
        """Dedup by (non-canonical) key, keeping the max-weight observation
        (reference :558-571)."""
        key = (match.robot0_id, match.robot0_keyframe_id, match.robot1_id,
               match.robot1_keyframe_id)
        if key in self.candidate_edges:
            if match.weight > self.candidate_edges[key].weight:
                self.add_candidate_edge(match)
        else:
            self.add_candidate_edge(match)

    # ------------------------------------------------------------------
    # Initializations
    # ------------------------------------------------------------------
    def greedy_initialization(self, nb_candidates_to_choose: int,
                              edges: Sequence[Edge]) -> np.ndarray:
        """Top-k by weight."""
        nb_edges = len(edges)
        w_init = np.zeros(nb_edges, dtype=np.float32)
        k = min(nb_candidates_to_choose, nb_edges)
        if k > 0:
            weights = np.array([e.weight for e in edges])
            indices = np.argpartition(weights, -k)[-k:]
            w_init[indices] = 1.0
        return w_init

    def pseudo_greedy_initialization(self, nb_candidates_to_choose: int,
                                     nb_random: int,
                                     edges: Sequence[Edge]) -> np.ndarray:
        """Greedy for k - nb_random edges, then random extras (:219-244)."""
        nb_greedy = nb_candidates_to_choose - nb_random
        w_init = self.greedy_initialization(nb_greedy, edges)
        nb_edges = len(edges)
        i = 0
        trial = 0
        max_trials = 2 * nb_random
        while i < nb_random and trial < max_trials:
            j = int(self._rng.random() * nb_edges)
            if w_init[j] < 0.5:
                w_init[j] = 1.0
                i += 1
            trial += 1
        if trial >= max_trials:
            w_init = self.greedy_initialization(nb_candidates_to_choose, edges)
        return w_init

    def random_initialization(self, nb_candidates_to_choose: int,
                              edges: List[Edge]) -> np.ndarray:
        edges = [
            self.replace_weight(e, float(self._rng.random())) for e in edges
        ]
        return self.greedy_initialization(nb_candidates_to_choose, edges)

    def connection_biased_greedy_selection(
            self, nb_candidates_to_choose: int,
            edges: Sequence[EdgeInterRobot],
            is_robot_included: Dict[int, bool]) -> np.ndarray:
        """Prefer the best edge to each not-yet-connected robot, then
        greedy for the remainder (:256-288)."""
        edges = list(edges)
        chosen_ids = []
        weights = [e.weight for e in edges]
        for rid in (r for r, inc in is_robot_included.items() if inc):
            if not self.initial_fixed_edge_exists[rid]:
                best, best_w = None, -1.0
                for i, e in enumerate(edges):
                    if (e.robot0_id == rid or e.robot1_id == rid) \
                            and weights[i] > best_w:
                        best, best_w = i, weights[i]
                if best is not None:
                    chosen_ids.append(best)
                    weights[best] = 0.0
        w_init = np.zeros(len(edges), dtype=np.float32)
        remaining = nb_candidates_to_choose - len(chosen_ids)
        if remaining > 0:
            masked = [self.replace_weight(e, w) for e, w in zip(edges, weights)]
            w_init = self.greedy_initialization(
                remaining,
                self.rekey_edges(masked, is_robot_included))
        for i in chosen_ids:
            w_init[i] = 1.0
        return w_init

    # ------------------------------------------------------------------
    # Rekeying between (robot, keyframe) keys and contiguous node ids
    # ------------------------------------------------------------------
    def compute_offsets(self, is_robot_included: Dict[int, bool]):
        """Node-id base per robot: cumulative pose count over the included
        robots that precede it; excluded robots keep base 0."""
        running_total = 0
        self.offsets = {}
        for rid in range(self.max_nb_robots):
            self.offsets[rid] = running_total if is_robot_included[rid] else 0
            if is_robot_included[rid]:
                running_total += self.nb_poses[rid]

    def rekey_edges(self, edges: Sequence[EdgeInterRobot],
                    is_robot_included: Dict[int, bool]) -> List[Edge]:
        """(robot, keyframe) endpoints -> contiguous node ids; edges
        touching an excluded robot are dropped."""
        return [
            Edge(self.offsets[e.robot0_id] + e.robot0_keyframe_id,
                 self.offsets[e.robot1_id] + e.robot1_keyframe_id, e.weight)
            for e in self.get_included_edges(edges, is_robot_included)
        ]

    def get_included_edges(self, edges: Sequence[EdgeInterRobot],
                           is_robot_included: Dict[int, bool]):
        return [
            e for e in edges
            if is_robot_included[e.robot0_id] and is_robot_included[e.robot1_id]
        ]

    def fill_odometry(self) -> List[Edge]:
        """Odometry chain edges inferred from pose counts (:347-361)."""
        return [
            Edge(base + k, base + k + 1, self.fixed_weight)
            for rid in range(len(self.nb_poses))
            for base in (self.offsets[rid],)
            for k in range(self.nb_poses[rid] - 1)
        ]

    def _node_owner(self, node: int, is_robot_included: Dict[int,
                                                             bool]) -> int:
        """Included robot owning a contiguous node id: the highest robot id
        whose base does not exceed the node (ties on equal bases — empty
        included robots — resolve to the later id, matching the reference
        recovery loop :363-388)."""
        owner = 0
        for rid, base in self.offsets.items():
            if rid and is_robot_included[rid] and node >= base:
                owner = rid
        return owner

    def recover_inter_robot_edges(
            self, edges: Sequence[Edge],
            is_robot_included: Dict[int, bool]) -> List[EdgeInterRobot]:
        """Invert rekey_edges: node id -> (robot, keyframe)."""
        recovered = []
        for e in edges:
            r0 = self._node_owner(e.i, is_robot_included)
            r1 = self._node_owner(e.j, is_robot_included)
            recovered.append(
                EdgeInterRobot(r0, e.i - self.offsets[r0], r1,
                               e.j - self.offsets[r1], e.weight))
        return recovered

    # ------------------------------------------------------------------
    # Connectivity checks
    # ------------------------------------------------------------------
    def check_graph_disconnections(
            self,
            is_other_robot_considered: Dict[int, bool]) -> Dict[int, bool]:
        """A robot is included iff it is considered AND touches any edge
        (the local robot is always included) (:390-416)."""
        is_robot_connected = {
            i: (i == self.robot_id) for i in range(self.max_nb_robots)
        }
        for edge in list(self.fixed_edges) + list(
                self.candidate_edges.values()):
            if is_other_robot_considered[edge.robot0_id]:
                is_robot_connected[edge.robot0_id] = True
            if is_other_robot_considered[edge.robot1_id]:
                is_robot_connected[edge.robot1_id] = True
        return is_robot_connected

    def check_initial_fixed_measurements_exists(
            self, is_robot_included: Dict[int, bool]) -> bool:
        return all(self.initial_fixed_edge_exists[rid]
                   for rid, inc in is_robot_included.items() if inc)

    # ------------------------------------------------------------------
    # Selection
    # ------------------------------------------------------------------
    def run_mac_solver(self, fixed_edges: Sequence[Edge],
                       candidate_edges: Sequence[Edge], w_init,
                       nb_candidates_to_choose: int) -> np.ndarray:
        """MAC with the disconnection-retry loop (:435-465)."""
        mac = MAC(fixed_edges, candidate_edges, self.total_nb_poses,
                  device=self.device)
        result = np.asarray(w_init).copy()
        trial = 0
        while trial < nb_candidates_to_choose:
            try:
                result = mac.fw_subset(w_init, nb_candidates_to_choose,
                                       max_iters=self.max_iters).w
                break
            except DisconnectedGraphError:
                trial += 1
                w_init = self.pseudo_greedy_initialization(
                    nb_candidates_to_choose, trial, candidate_edges)
                continue
        return result

    def select_candidates(self,
                          nb_candidates_to_choose: int,
                          is_other_robot_considered: Dict[int, bool],
                          greedy_initialization: bool = True
                          ) -> List[EdgeInterRobot]:
        """Budgeted selection of candidate edges (:467-542)."""
        is_robot_included = self.check_graph_disconnections(
            is_other_robot_considered)

        self.compute_offsets(is_robot_included)
        rekeyed_fixed_edges = self.rekey_edges(self.fixed_edges,
                                               is_robot_included)
        rekeyed_fixed_edges.extend(self.fill_odometry())
        # Selection-side similarity floor (config
        # frontend.candidate_selection_min_weight): below-floor
        # candidates are unverifiable with high probability (measured,
        # SCALING.md §5) — keep them in the pool but out of this
        # round's budget. The floor PRIORITIZES, it must not starve:
        # when above-floor candidates alone cannot fill the budget
        # (small worlds / early mission), backfill with the
        # highest-weight below-floor candidates so selection never
        # returns empty while candidates exist.
        floor = float(self.params.get(
            "frontend.candidate_selection_min_weight", 0.0))
        all_candidates = list(self.candidate_edges.values())
        candidate_pool = [e for e in all_candidates if e.weight >= floor]
        if len(candidate_pool) < nb_candidates_to_choose:
            below = sorted((e for e in all_candidates if e.weight < floor),
                           key=lambda e: e.weight, reverse=True)
            candidate_pool.extend(
                below[:nb_candidates_to_choose - len(candidate_pool)])
        rekeyed_candidate_edges = self.rekey_edges(
            candidate_pool, is_robot_included)

        nb_candidates_to_choose = min(nb_candidates_to_choose,
                                      len(rekeyed_candidate_edges))
        if not rekeyed_candidate_edges:
            return []

        self.total_nb_poses = sum(
            self.nb_poses[n] for n in range(len(self.nb_poses)))

        if greedy_initialization:
            w_init = self.greedy_initialization(nb_candidates_to_choose,
                                                rekeyed_candidate_edges)
        else:
            w_init = self.random_initialization(nb_candidates_to_choose,
                                                rekeyed_candidate_edges)

        if self.params.get("frontend.enable_sparsification", True) and \
                self.check_initial_fixed_measurements_exists(is_robot_included):
            result = self.run_mac_solver(rekeyed_fixed_edges,
                                         rekeyed_candidate_edges, w_init,
                                         nb_candidates_to_choose)
        else:
            result = self.connection_biased_greedy_selection(
                nb_candidates_to_choose,
                self.get_included_edges(candidate_pool, is_robot_included),
                is_robot_included)

        if self.params.get("evaluation.enable_sparsification_comparison",
                           False):
            self.sparsification_comparison_logs(rekeyed_candidate_edges,
                                                is_robot_included, w_init,
                                                result)

        selected = [
            rekeyed_candidate_edges[i]
            for i in np.nonzero(np.asarray(result).astype(int))[0]
        ]
        inter_robot_edges = self.recover_inter_robot_edges(
            selected, is_robot_included)
        self.remove_candidate_edges(inter_robot_edges)
        return inter_robot_edges

    def sparsification_comparison_logs(self, rekeyed_candidate_edges,
                                       is_robot_included, greedy_result,
                                       mac_result):
        self.log_greedy_edges = self.recover_inter_robot_edges([
            rekeyed_candidate_edges[i]
            for i in np.nonzero(np.asarray(greedy_result).astype(int))[0]
        ], is_robot_included)
        self.log_mac_edges = self.recover_inter_robot_edges([
            rekeyed_candidate_edges[i]
            for i in np.nonzero(np.asarray(mac_result).astype(int))[0]
        ], is_robot_included)
