"""Neighbor management: who is in range, broker election, gossip
high-watermarks.

Port of cslam_tpu/comm/neighbors_manager.py (pure Python).

Capability parity with the reference NeighborManager
(Swarm-SLAM cslam/neighbors_manager.py): liveness aggregation over
per-neighbor monitors, broker = lowest alive robot id (:48-64), windowed
send bookkeeping for descriptors and matches (:66-136), unknown-range
filtering of received descriptor batches (:147-169), and the
current-neighbors query topic used by the PGO state machine (:171-185).
"""

from typing import Dict, List, Tuple

from cslam_tpu_torch.comm.messages import RobotIdsAndOrigin
from cslam_tpu_torch.comm.neighbor_monitor import NeighborMonitor


class NeighborManager:

    def __init__(self, bus, clock, params: Dict):
        self.bus = bus
        self.clock = clock
        self.params = params
        self.robot_id = params["robot_id"]
        self.max_nb_robots = params["max_nb_robots"]
        self.neighbors_monitors = {
            rid: NeighborMonitor(
                bus, clock, rid,
                params["neighbor_management.enable_neighbor_monitoring"],
                params["neighbor_management.init_delay_sec"],
                params["neighbor_management.max_heartbeat_delay_sec"])
            for rid in range(self.max_nb_robots) if rid != self.robot_id
        }
        bus.subscribe("cslam/get_current_neighbors",
                      self.get_current_neighbors_callback)
        self.neighbors_publisher = bus.create_publisher(
            "cslam/current_neighbors")

    def check_neighbors_in_range(self) -> Tuple[Dict[int, bool], List[int]]:
        is_robot_in_range = {}
        robots_in_range_list = []
        for i in range(self.max_nb_robots):
            if i == self.robot_id or self.neighbors_monitors[i].is_alive():
                is_robot_in_range[i] = True
                robots_in_range_list.append(i)
            else:
                is_robot_in_range[i] = False
        return is_robot_in_range, robots_in_range_list

    def local_robot_is_broker(self) -> bool:
        """Lowest alive id is the broker (reference :48-64)."""
        return not any(
            i < self.robot_id and self.neighbors_monitors[i].is_alive()
            for i in range(self.max_nb_robots) if i != self.robot_id)

    def select_from_which_kf_to_send(self, latest_local_id: int) -> int:
        """Minimum high-watermark over alive neighbors, then update all
        alive watermarks to the latest id (reference :66-85)."""
        from_kf_id = latest_local_id
        for i, mon in self.neighbors_monitors.items():
            if mon.is_alive():
                from_kf_id = min(mon.last_keyframe_sent, from_kf_id)
        for i, mon in self.neighbors_monitors.items():
            if mon.is_alive():
                mon.last_keyframe_sent = latest_local_id
        return from_kf_id + 1

    def select_from_which_match_to_send(self,
                                        latest_local_match_idx: int) -> int:
        from_match_id = latest_local_match_idx
        for mon in self.neighbors_monitors.values():
            if mon.is_alive():
                from_match_id = min(mon.last_match_sent, from_match_id)
        for mon in self.neighbors_monitors.values():
            if mon.is_alive():
                mon.last_match_sent = latest_local_match_idx
        return from_match_id + 1

    def useless_descriptors(self, last_kf_id: int) -> int:
        """First descriptor id still needed by any neighbor (:108-121)."""
        from_kf_id = last_kf_id
        for mon in self.neighbors_monitors.values():
            from_kf_id = min(mon.last_keyframe_sent, from_kf_id)
        return from_kf_id

    def useless_matches(self, last_match_id: int) -> int:
        from_match_id = last_match_id
        for mon in self.neighbors_monitors.values():
            from_match_id = min(mon.last_match_sent, from_match_id)
        return from_match_id

    def update_received_kf_id(self, other_robot_id: int, kf_id: int):
        self.neighbors_monitors[other_robot_id].last_keyframe_received = kf_id

    def get_unknown_range(self, descriptors) -> List[int]:
        """Indices of received descriptors newer than the last known id
        from that robot (:147-169)."""
        other_robot_id = descriptors[0].robot_id
        last_id = max(d.keyframe_id for d in descriptors)
        mon = self.neighbors_monitors[other_robot_id]
        unknown = [
            i for i in range(len(descriptors))
            if descriptors[i].keyframe_id > mon.last_keyframe_received
        ]
        self.update_received_kf_id(
            other_robot_id, max(mon.last_keyframe_received, last_id))
        return unknown

    def get_current_neighbors_callback(self, _msg):
        """Answer the back-end's neighbor query (:171-185)."""
        _, robots_in_range_list = self.check_neighbors_in_range()
        robots_in_range_list = [
            r for r in robots_in_range_list if r != self.robot_id
        ]
        msg = RobotIdsAndOrigin(
            ids=robots_in_range_list,
            origins=[
                self.neighbors_monitors[i].origin_robot_id
                for i in robots_in_range_list
            ])
        self.neighbors_publisher.publish(msg)
