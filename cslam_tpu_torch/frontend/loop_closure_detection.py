"""Global-descriptor loop-closure detection orchestrator.

Port of cslam_tpu/frontend/loop_closure_detection.py. Every ingested or
gossiped descriptor goes through the port's `DescriptorDatabase`, whose
"auto" search runs the hand-written CUDA cosine top-k kernel on a card
(its plain version on the CPU); lidar robots match Scan Contexts
(`matching/scancontext_matching.py`) instead. `device=` chooses where
the matcher, its MAC selection and the model it builds when no
descriptor_model is passed (CosPlace, or the Scan Context model with
`frontend.global_descriptor_technique: scancontext`) run (None = the
CUDA card).

Capability parity with the reference GlobalDescriptorLoopClosureDetection
(Swarm-SLAM cslam/global_descriptor_loop_closure_detection.py): per
incoming descriptor — local matching, intra-robot detection, buffering
for windowed gossip; periodically — gossip publication gated on neighbor
high-watermarks, and (on the elected broker) MAC-budgeted candidate
selection + vertex-cover brokerage dispatching LocalDescriptorsRequests.

Differences by design (documented, not accidental):
- transport is the bus abstraction (comm/bus.py),
  timers are explicit tick methods driven by the host runtime;
- the reference's lidar-path callback references an undefined
  receive_keyframe (g_d_l_c_d.py:86-88); here the lidar path computes the
  ScanContext embedding on keyframe receipt and feeds the same pipeline;
- the match-filter for two-neighbor transmissions does not mutate the
  list being iterated (reference defect at g_d_l_c_d.py:249-257).
"""

import time
from typing import Dict

import numpy as np

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.comm.neighbors_manager import NeighborManager
from cslam_tpu_torch.device import DeviceLike
from cslam_tpu_torch.matching.sparse_matching import \
    LoopClosureSparseMatching
from cslam_tpu_torch.runtime.tracing import span
from cslam_tpu_torch.sparsification.broker import Broker
from cslam_tpu_torch.utils.edges import EdgeInterRobot
from cslam_tpu_torch.utils.misc import dict_to_list_chunks


class GlobalDescriptorLoopClosureDetection:

    def __init__(self, params: Dict, bus, clock, descriptor_model=None,
                 logger=None, device: DeviceLike = None):
        self.params = params
        self.bus = bus
        self.clock = clock
        self.logger = logger
        self.lcm = LoopClosureSparseMatching(params, device=device)
        self.neighbor_manager = NeighborManager(bus, clock, params)

        technique = params.get("frontend.global_descriptor_technique",
                               "cosplace").lower()
        self.keyframe_type = "pointcloud" if technique == "scancontext" \
            else "rgb"
        if descriptor_model is not None:
            self.global_descriptor = descriptor_model
        elif technique == "scancontext":
            from cslam_tpu_torch.frontend.lidar_handler import \
                ScanContextModel
            self.global_descriptor = ScanContextModel(params, device=device)
        else:
            from cslam_tpu_torch.models.cosplace import CosPlace
            self.global_descriptor = CosPlace(params, device=device)

        # pub/sub wiring (absolute topics are swarm-wide)
        self.global_descriptor_publisher = bus.create_publisher(
            "/cslam/global_descriptors")
        bus.subscribe("/cslam/global_descriptors",
                      self.global_descriptor_callback)
        self.inter_robot_matches_publisher = bus.create_publisher(
            "/cslam/inter_robot_matches")
        bus.subscribe("/cslam/inter_robot_matches",
                      self.inter_robot_matches_callback)
        self.local_match_publisher = bus.create_publisher(
            "cslam/local_keyframe_match")
        bus.subscribe("/cslam/inter_robot_loop_closure",
                      self.receive_inter_robot_loop_closure)
        if self.keyframe_type == "rgb":
            bus.subscribe("cslam/processed_global_descriptor",
                          self.receive_descriptor)
        else:
            bus.subscribe("cslam/keyframe_data", self.receive_keyframe)
        self.local_descriptors_request_publishers = {
            i: bus.create_publisher(
                f"/r{i}/cslam/local_descriptors_request")
            for i in range(params["max_nb_robots"])
        }

        self.global_descriptors_buffer: Dict[int, msgs.GlobalDescriptor] = {}
        self.inter_robot_matches_buffer: Dict[int, EdgeInterRobot] = {}
        self.nb_inter_robot_matches = 0

        # metrics counters (reference log_* at g_d_l_c_d.py:125-135)
        self.log_total_successful_matches = 0
        self.log_total_failed_matches = 0
        self.log_total_vertices_transmitted = 0
        self.log_total_matches_selected = 0
        self.log_detection_cumulative_communication = 0
        self.log_total_sparsification_computation_time = 0.0
        # broker detection-tick phase breakdown (host ms per phase)
        self.tick_phase_ms = {"sparsification": 0.0, "broker": 0.0,
                              "publish": 0.0, "knn_ingest": 0.0}
        self.n_detection_ticks = 0
        # per-verification outcome + the candidate's descriptor weight
        # at verification time
        self.verification_outcomes = []

    # ------------------------------------------------------------------
    # Ingestion
    # ------------------------------------------------------------------
    def receive_keyframe(self, msg):
        """Lidar path: compute the ScanContext embedding for an incoming
        keyframe pointcloud then process it (fixes the reference's
        undefined receive_keyframe, g_d_l_c_d.py:86-88)."""
        embedding = self.global_descriptor.compute_embedding(msg.points)
        self.add_global_descriptor_to_map(embedding, msg.id)

    def receive_descriptor(self, msg: msgs.GlobalDescriptor):
        self.add_global_descriptor_to_map(np.asarray(msg.descriptor),
                                          msg.keyframe_id)

    def add_global_descriptor_to_map(self, embedding, kf_id: int):
        """Match + buffer a local keyframe descriptor (reference :145-168)."""
        matches = self.lcm.add_local_global_descriptor(embedding, kf_id)
        self.detect_intra(embedding, kf_id)
        self.global_descriptors_buffer[kf_id] = msgs.GlobalDescriptor(
            keyframe_id=kf_id, robot_id=self.params["robot_id"],
            descriptor=np.asarray(embedding, dtype=np.float32))
        for match in matches:
            self.inter_robot_matches_buffer[
                self.nb_inter_robot_matches] = match
            self.nb_inter_robot_matches += 1

    # ------------------------------------------------------------------
    # Gossip (windowed, watermark-gated)
    # ------------------------------------------------------------------
    def delete_useless_descriptors(self):
        if not self.global_descriptors_buffer:
            return
        last = max(self.global_descriptors_buffer.keys())
        from_kf_id = self.neighbor_manager.useless_descriptors(last)
        first = min(self.global_descriptors_buffer.keys())
        if from_kf_id >= first:
            for k in list(self.global_descriptors_buffer.keys()):
                if k < from_kf_id:
                    del self.global_descriptors_buffer[k]

    def delete_useless_inter_robot_matches(self):
        if not self.inter_robot_matches_buffer:
            return
        last = max(self.inter_robot_matches_buffer.keys())
        from_id = self.neighbor_manager.useless_matches(last)
        first = min(self.inter_robot_matches_buffer.keys())
        if from_id >= first:
            for k in list(self.inter_robot_matches_buffer.keys()):
                if k < from_id:
                    del self.inter_robot_matches_buffer[k]

    def global_descriptors_timer_callback(self):
        """Publish new descriptors to the swarm (reference :192-221)."""
        if not self.global_descriptors_buffer:
            return
        last = max(self.global_descriptors_buffer.keys())
        first = min(self.global_descriptors_buffer.keys())
        from_kf_id = self.neighbor_manager.select_from_which_kf_to_send(last)
        chunks = dict_to_list_chunks(
            self.global_descriptors_buffer, from_kf_id - first,
            self.params["frontend.detection_publication_max_elems_per_msg"])
        quant = self.params.get(
            "frontend.gossip_descriptor_quantization", "none")
        for chunk in chunks:
            if not chunk:
                continue
            out = msgs.GlobalDescriptors(descriptors=chunk,
                                         quantization=quant)
            self.global_descriptor_publisher.publish(out)
            dim = len(chunk[0].descriptor)
            # reference accounting is 4 B/float (g_d_l_c_d.py:210-214);
            # int8 gossip ships 1 B/element + 16 B ids/scale/min.
            # Ask the message which encoding it will ACTUALLY emit —
            # mixed-size chunks silently fall back to the float layout
            # and would otherwise undercount ~4x.
            per_desc = dim + 16 if out.uses_int8_encoding() else dim * 4
            self.log_detection_cumulative_communication += (
                len(chunk) * per_desc)
        self.delete_useless_descriptors()
        self._log("detection_cumulative_communication",
                  self.log_detection_cumulative_communication)

    def inter_robot_matches_timer_callback(self):
        """Publish new candidate matches (reference :235-283)."""
        if not self.inter_robot_matches_buffer:
            return
        last = max(self.inter_robot_matches_buffer.keys())
        first = min(self.inter_robot_matches_buffer.keys())
        from_idx = self.neighbor_manager.select_from_which_match_to_send(last)
        chunks = dict_to_list_chunks(
            self.inter_robot_matches_buffer, from_idx - first,
            self.params["frontend.detection_publication_max_elems_per_msg"])
        # With exactly two robots in range, both already know any match
        # between them — skip those (reference :248-257, without mutating
        # the iterated list).
        _, in_range = self.neighbor_manager.check_neighbors_in_range()
        if len(in_range) == 2:
            chunks = [[m for m in c
                       if not (m.robot0_id in in_range
                               and m.robot1_id in in_range)]
                      for c in chunks]
            chunks = [c for c in chunks if c]
        for chunk in chunks:
            out = msgs.InterRobotMatches(
                robot_id=self.params["robot_id"],
                matches=[
                    msgs.InterRobotMatch(m.robot0_id, m.robot0_keyframe_id,
                                         m.robot1_id, m.robot1_keyframe_id,
                                         float(m.weight)) for m in chunk
                ])
            self.inter_robot_matches_publisher.publish(out)
            self.log_detection_cumulative_communication += len(chunk) * 20
        self.delete_useless_inter_robot_matches()
        self._log("detection_cumulative_communication",
                  self.log_detection_cumulative_communication)

    # ------------------------------------------------------------------
    # Detection
    # ------------------------------------------------------------------
    def detect_intra(self, embedding, kf_id: int):
        """Intra-robot loop-closure detection (reference :285-303)."""
        if not self.params.get("frontend.enable_intra_robot_loop_closures",
                               False):
            return
        kf_match, _sims = self.lcm.match_local_loop_closures(embedding, kf_id)
        if kf_match is not None:
            self.local_match_publisher.publish(
                msgs.LocalKeyframeMatch(keyframe0_id=kf_id,
                                        keyframe1_id=kf_match))

    def detect_inter(self):
        """Budgeted inter-robot detection on the elected broker
        (reference :305-360)."""
        neighbors_in_range, in_range_list = \
            self.neighbor_manager.check_neighbors_in_range()
        if not in_range_list or not \
                self.neighbor_manager.local_robot_is_broker():
            return []
        start_time = time.monotonic()
        with span("sparsification_select", robot=self.params["robot_id"]):
            selection = self.lcm.select_candidates(
                int(self.params["frontend.inter_robot_loop_closure_budget"]),
                neighbors_in_range)
        t_sparsify = time.monotonic()
        vertices_info = self.edge_list_to_vertices(selection)
        broker = Broker(selection, in_range_list)
        cover = broker.brokerage(
            self.params["frontend.use_vertex_cover_selection"])
        t_broker = time.monotonic()
        for selected_vertices_set in cover:
            for v in selected_vertices_set:
                request = msgs.LocalDescriptorsRequest(
                    keyframe_id=v[1],
                    matches_robot_id=vertices_info[v][0],
                    matches_keyframe_id=vertices_info[v][1])
                self.local_descriptors_request_publishers[v[0]].publish(
                    request)
            self.log_total_vertices_transmitted += len(selected_vertices_set)
        t_publish = time.monotonic()
        self.tick_phase_ms["sparsification"] += (t_sparsify -
                                                 start_time) * 1e3
        self.tick_phase_ms["broker"] += (t_broker - t_sparsify) * 1e3
        self.tick_phase_ms["publish"] += (t_publish - t_broker) * 1e3
        self.n_detection_ticks += 1
        self.log_total_sparsification_computation_time += (
            time.monotonic() - start_time)
        self.log_total_matches_selected += len(selection)
        # persist the greedy-vs-MAC comparison streams as CSVs
        # (reference spectral_matches.csv, logger.cpp:174-191)
        if self.logger is not None and hasattr(self.logger, "log_matches") \
                and self.params.get(
                    "evaluation.enable_sparsification_comparison", False):
            cs = self.lcm.candidate_selector
            self.logger.log_matches("spectral_matches",
                                    getattr(cs, "log_mac_edges", []))
            self.logger.log_matches("greedy_matches",
                                    getattr(cs, "log_greedy_edges", []))
        self._log("sparsification_cumulative_computation_time",
                  self.log_total_sparsification_computation_time)
        self._log("nb_vertices_transmitted",
                  self.log_total_vertices_transmitted)
        self._log("nb_matches_selected", self.log_total_matches_selected)
        return selection

    @staticmethod
    def edge_list_to_vertices(selection):
        """Vertices of selected edges with their partner lists
        (reference :362-383)."""
        vertices = {}
        for s in selection:
            key0 = (s.robot0_id, s.robot0_keyframe_id)
            key1 = (s.robot1_id, s.robot1_keyframe_id)
            for key, (orid, okid) in ((key0, (s.robot1_id,
                                              s.robot1_keyframe_id)),
                                      (key1, (s.robot0_id,
                                              s.robot0_keyframe_id))):
                if key in vertices:
                    vertices[key][0].append(orid)
                    vertices[key][1].append(okid)
                else:
                    vertices[key] = [[orid], [okid]]
        return vertices

    # ------------------------------------------------------------------
    # Swarm callbacks
    # ------------------------------------------------------------------
    def global_descriptor_callback(self, msg: msgs.GlobalDescriptors):
        """Descriptors gossiped by other robots (reference :388-404)."""
        if not msg.descriptors or \
                msg.descriptors[0].robot_id == self.params["robot_id"]:
            return
        unknown = self.neighbor_manager.get_unknown_range(msg.descriptors)
        t0 = time.monotonic()
        for i in unknown:
            match = self.lcm.add_other_robot_global_descriptor(
                msg.descriptors[i])
            if match is not None:
                self.inter_robot_matches_buffer[
                    self.nb_inter_robot_matches] = match
                self.nb_inter_robot_matches += 1
        self.tick_phase_ms["knn_ingest"] += (time.monotonic() - t0) * 1e3

    def inter_robot_matches_callback(self, msg: msgs.InterRobotMatches):
        """Matches detected by other robots (reference :406-416)."""
        if msg.robot_id == self.params["robot_id"]:
            return
        for match in msg.matches:
            self.lcm.candidate_selector.add_match(
                EdgeInterRobot(match.robot0_id, match.robot0_keyframe_id,
                               match.robot1_id, match.robot1_keyframe_id,
                               match.weight))

    def inter_robot_loop_closure_msg_to_edge(self, msg):
        return EdgeInterRobot(msg.robot0_id, msg.robot0_keyframe_id,
                              msg.robot1_id, msg.robot1_keyframe_id,
                              self.lcm.candidate_selector.fixed_weight)

    def receive_inter_robot_loop_closure(self,
                                         msg: msgs.InterRobotLoopClosure):
        """Geometric verification outcome (reference :432-467)."""
        edge = self.inter_robot_loop_closure_msg_to_edge(msg)
        cand = self.lcm.candidate_selector.candidate_edges.get(
            self.lcm.candidate_selector.edge_key(edge))
        self.verification_outcomes.append(
            {"success": bool(msg.success),
             "weight": float(cand.weight) if cand is not None else None,
             "pair": (int(msg.robot0_id), int(msg.robot1_id))})
        if msg.success:
            self.lcm.candidate_selector.candidate_edges_to_fixed([edge])
            self.log_total_successful_matches += 1
            self._log("nb_matches", self.log_total_successful_matches)
        else:
            self.lcm.candidate_selector.remove_candidate_edges([edge],
                                                               failed=True)
            self.log_total_failed_matches += 1
            self._log("nb_failed_matches", self.log_total_failed_matches)

    def _log(self, key: str, value):
        if self.logger is not None:
            self.logger.log_info(key, value)
