"""Per-robot node composition: front-end + back-end over one bus.

Port of cslam_tpu/node.py. A SwarmNode owns one robot's loop-closure
detection, neighbor management and decentralized PGO, and exposes
explicit timer ticks the host runtime (or a test) drives — the
reference's ROS timers map 1:1 onto these ticks (Swarm-SLAM
launch/cslam.launch.py:78-91 assembles the same components per robot).

`device=` is where the robot's descriptor databases, MAC selection and
pose-graph solves run: None means the CUDA card (and raises without
one); tests pass "cpu".
"""

from typing import Dict, Optional

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.decentralized_pgo import DecentralizedPGO
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.frontend.loop_closure_detection import \
    GlobalDescriptorLoopClosureDetection
from cslam_tpu_torch.runtime.tracing import span


class SwarmNode:

    def __init__(self, params: Dict, bus, clock, descriptor_model=None,
                 logger=None, pgo_config: Optional[pgo.PGOConfig] = None,
                 solver=None, device: DeviceLike = None):
        self.params = params
        self.bus = bus
        self.clock = clock
        self.robot_id = params["robot_id"]
        self.device = resolve_device(device)
        self.detection = GlobalDescriptorLoopClosureDetection(
            params, bus, clock, descriptor_model=descriptor_model,
            logger=logger, device=self.device)
        self.backend = DecentralizedPGO(params, bus, clock, logger=logger,
                                        pgo_config=pgo_config,
                                        solver=solver, device=self.device)

    def close(self):
        """Stop the back-end's solver thread (waits for a running solve)."""
        self.backend.close()

    # Timer ticks (period params in parentheses, reference declarations
    # at loop_closure_detection_node.py:20-44 and example.yaml):
    def tick_detection_publication(self):
        """(frontend.detection_publication_period_sec)"""
        with span("detection_publication", robot=self.robot_id):
            self.detection.global_descriptors_timer_callback()
            self.detection.inter_robot_matches_timer_callback()

    def tick_inter_robot_detection(self):
        """(frontend.inter_robot_detection_period_sec)"""
        with span("inter_robot_detection", robot=self.robot_id):
            return self.detection.detect_inter()

    def tick_heartbeat(self):
        """(neighbor_management.heartbeat_period_sec)"""
        with span("heartbeat", robot=self.robot_id):
            self.backend.heartbeat_timer_callback()

    def tick_optimization_start(self):
        """(backend.pose_graph_optimization_start_period_ms)"""
        with span("optimization_start", robot=self.robot_id):
            self.backend.optimization_callback()

    def tick_optimization_loop(self):
        """(backend.pose_graph_optimization_loop_period_ms)"""
        with span("optimization_loop", robot=self.robot_id):
            self.backend.optimization_loop_callback()
