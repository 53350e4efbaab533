"""Simulated rendezvous: deterministic connectivity schedules for
multi-robot fault-injection tests.

Port of cslam_tpu/comm/rendezvous.py (pure Python).

Capability parity with the reference SimulatedRendezVous
(Swarm-SLAM src/back_end/utils/simulated_rendezvous.cpp:5-69): a CSV
schedule `robot_id,start,end,start,end,...` per line; `is_alive()` is
true only inside the robot's scheduled windows; on any schedule-reading
failure the robot stays alive (the reference swallows exceptions and
keeps is_alive true). Heartbeat emission is gated on this
(decentralized_pgo.cpp:732-737).
"""

from typing import List, Tuple


class SimulatedRendezVous:

    def __init__(self, clock, schedule_file: str, robot_id: int,
                 enabled: bool = True):
        self.clock = clock
        self.robot_id = robot_id
        self.enabled = enabled
        self.windows: List[Tuple[float, float]] = []
        if enabled:
            try:
                with open(schedule_file) as f:
                    for line in f:
                        fields = line.strip().split(",")
                        if not fields or fields[0] == "":
                            continue
                        if int(fields[0]) != robot_id:
                            continue
                        times = [float(v) for v in fields[1:] if v != ""]
                        self.windows = list(zip(times[0::2], times[1::2]))
            except Exception:
                # match the reference: failures leave the robot alive
                self.enabled = False

    def is_alive(self) -> bool:
        if not self.enabled:
            return True
        now = self.clock.now()
        return any(start <= now <= end for start, end in self.windows)
