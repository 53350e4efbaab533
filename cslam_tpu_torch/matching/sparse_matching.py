"""Loop-closure sparse matching: descriptor databases + budgeted selection.

Port of cslam_tpu/matching/sparse_matching.py: per-robot descriptor
databases, local/cross-robot best-match search producing candidate
EdgeInterRobot matches, and MAC-budgeted candidate selection. With
`frontend.sensor_type: lidar` the databases are Scan Context databases
(`matching/scancontext_matching.py`), else descriptor databases.
"""

from typing import Dict

import numpy as np

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.matching.scancontext_matching import \
    ScanContextMatching
from cslam_tpu_torch.sparsification.acm import \
    AlgebraicConnectivityMaximization
from cslam_tpu_torch.utils.edges import EdgeInterRobot


class LoopClosureSparseMatching:
    """Matches global descriptors into loop-closure candidates, then
    selects candidates under the communication budget."""

    def __init__(self, params: Dict, node=None, device: DeviceLike = None):
        self.params = params
        self.node = node
        self.device = resolve_device(device)
        if self.params.get("frontend.sensor_type") == "lidar":
            def make_db():
                return ScanContextMatching(device=self.device)
        else:
            method = self.params.get("frontend.nns_method", "auto")
            storage = self.params.get("frontend.nns_storage", "float32")

            def make_db():
                return DescriptorDatabase(method=method, storage=storage,
                                          device=self.device)
        self.local_nnsm = make_db()
        self.other_robots_nnsm = {
            i: make_db()
            for i in range(self.params["max_nb_robots"])
            if i != self.params["robot_id"]
        }
        self.candidate_selector = AlgebraicConnectivityMaximization(
            self.params["robot_id"], self.params["max_nb_robots"],
            extra_params=self.params, device=self.device)

    def add_local_global_descriptor(self, embedding, keyframe_id):
        """Store a local keyframe descriptor and match it against every
        other robot's database."""
        matches = []
        embedding = np.asarray(embedding, dtype=np.float32)
        self.local_nnsm.add_item(embedding, keyframe_id)
        for i in range(self.params["max_nb_robots"]):
            if i == self.params["robot_id"]:
                continue
            kf, similarity = self.other_robots_nnsm[i].search_best(embedding)
            if kf is not None and \
                    similarity >= self.params["frontend.similarity_threshold"]:
                match = EdgeInterRobot(self.params["robot_id"], keyframe_id,
                                       i, kf, float(similarity))
                self.candidate_selector.add_match(match)
                matches.append(match)
        return matches

    def add_other_robot_global_descriptor(self, msg):
        """Store another robot's descriptor and match it against the local
        database. `msg` needs .robot_id, .keyframe_id, .descriptor."""
        embedding = np.asarray(msg.descriptor, dtype=np.float32)
        self.other_robots_nnsm[msg.robot_id].add_item(embedding,
                                                      msg.keyframe_id)
        match = None
        kf, similarity = self.local_nnsm.search_best(embedding)
        if kf is not None and \
                similarity >= self.params["frontend.similarity_threshold"]:
            match = EdgeInterRobot(self.params["robot_id"], kf, msg.robot_id,
                                   msg.keyframe_id, float(similarity))
            self.candidate_selector.add_match(match)
        return match

    def match_local_loop_closures(self, descriptor, kf_id):
        """Best intra-robot match at least
        `intra_loop_min_inbetween_keyframes` away and above the
        similarity threshold."""
        kfs, similarities = self.local_nnsm.search(
            np.asarray(descriptor, dtype=np.float32),
            k=self.params["frontend.nb_best_matches"])
        if len(kfs) > 0 and kfs[0] == kf_id:
            kfs, similarities = kfs[1:], similarities[1:]
        if len(kfs) == 0:
            return None, similarities
        for kf, similarity in zip(kfs, similarities):
            if abs(kf - kf_id) < \
                    self.params["frontend.intra_loop_min_inbetween_keyframes"]:
                continue
            if similarity < self.params["frontend.similarity_threshold"]:
                continue
            return kf, similarities
        return None, similarities

    def select_candidates(self,
                          number_of_candidates: int,
                          is_neighbor_in_range: Dict[int, bool],
                          greedy_initialization: bool = True):
        """Budget-respecting inter-robot loop-closure selection."""
        return self.candidate_selector.select_candidates(
            int(number_of_candidates), dict(is_neighbor_in_range),
            greedy_initialization)
