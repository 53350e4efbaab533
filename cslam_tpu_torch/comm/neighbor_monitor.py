"""Per-neighbor heartbeat liveness monitor.

Port of cslam_tpu/comm/neighbor_monitor.py (pure Python).

Capability parity with the reference NeighborMonitor
(Swarm-SLAM cslam/neighbor_monitor.py): subscribes to the
neighbor's /rX/cslam/heartbeat topic; alive = first heartbeat seen, past
the init delay, and the latest heartbeat within the max-delay window.

The reference's defect at neighbor_monitor.py:53 (`else: True` without
`return`, making a disabled monitor report None/falsy) is fixed here:
monitoring disabled means always alive (SURVEY §2 #7, config README
"enable_neighbor_monitoring: false means always in range").
"""

from cslam_tpu_torch.comm.messages import Heartbeat


class NeighborMonitor:

    def __init__(self, bus, clock, rid: int, is_enabled: bool,
                 init_delay_sec: float, max_delay_sec: float):
        self.bus = bus
        self.clock = clock
        self.robot_id = rid
        self.is_enabled = is_enabled
        self.origin_robot_id = rid

        self.init_delay_sec = init_delay_sec
        self.max_delay_sec = max_delay_sec
        self.first_heartbeat_received = False
        self.init_time = clock.now()
        self.latest_time_stamp = self.init_time
        self.last_keyframe_received = -1
        self.last_keyframe_sent = -1
        self.last_match_sent = -1

        bus.subscribe(f"/r{rid}/cslam/heartbeat", self.heartbeat_callback)

    def heartbeat_callback(self, msg: Heartbeat):
        self.origin_robot_id = msg.origin_robot_id
        self.latest_time_stamp = self.clock.now()
        if not self.first_heartbeat_received:
            self.first_heartbeat_received = True
            self.init_time = self.clock.now()

    def is_alive(self) -> bool:
        if not self.is_enabled:
            return True
        now = self.clock.now()
        return (self.first_heartbeat_received
                and now - self.init_time > self.init_delay_sec
                and now - self.latest_time_stamp < self.max_delay_sec)
