"""Pub/sub message bus — the transport replacing ROS 2/DDS topics.

Port of cslam_tpu/comm/bus.py. Topic semantics mirror the reference:
cross-robot topics are absolute ("/cslam/...", "/rX/cslam/..."),
intra-robot topics are namespaced per robot. InProcessBus is a shared
router for N robot instances in one process — the
multi-robot-without-a-cluster mode the sim mission runs on. The TCP
bus between robot processes, with the same interface, is
runtime/native.py's NativeBus.

Delivery is deferred: published messages queue and deliver on
spin_once(), reproducing DDS's async callback model deterministically.
"""

import fnmatch
from collections import deque
from typing import Any, Callable, List, Tuple


class Publisher:
    def __init__(self, bus, topic):
        self._bus = bus
        self.topic = topic

    def publish(self, msg):
        self._bus.publish(self.topic, msg)


class InProcessRouter:
    """Shared topic router for one simulated swarm."""

    def __init__(self):
        self.subscribers: List[Tuple[str, Callable]] = []
        self.queue: deque = deque()
        self.delivered_count = 0

    def publish(self, topic: str, msg: Any):
        self.queue.append((topic, msg))

    def subscribe(self, topic: str, callback: Callable):
        self.subscribers.append((topic, callback))

    def spin_once(self, max_msgs: int = 10_000):
        """Deliver queued messages (including ones published during
        delivery, up to max_msgs)."""
        delivered = 0
        while self.queue and delivered < max_msgs:
            topic, msg = self.queue.popleft()
            for pattern, callback in list(self.subscribers):
                if pattern == topic or fnmatch.fnmatch(topic, pattern):
                    callback(msg)
            delivered += 1
            self.delivered_count += 1
        return delivered

    def spin_until_idle(self, max_rounds: int = 100):
        for _ in range(max_rounds):
            if not self.spin_once():
                return


class InProcessBus:
    """Per-robot view over a shared router, namespacing relative topics
    under /r<id>/ exactly like the reference's ROS namespaces."""

    def __init__(self, router: InProcessRouter, robot_id: int):
        self.router = router
        self.robot_id = robot_id

    def resolve(self, topic: str) -> str:
        if topic.startswith("/"):
            return topic
        return f"/r{self.robot_id}/{topic}"

    def create_publisher(self, topic: str) -> Publisher:
        return Publisher(self.router, self.resolve(topic))

    def publish(self, topic: str, msg):
        self.router.publish(self.resolve(topic), msg)

    def subscribe(self, topic: str, callback: Callable):
        self.router.subscribe(self.resolve(topic), callback)

    def spin_once(self):
        return self.router.spin_once()


class ManualClock:
    """Injectable time source so liveness windows are deterministic in
    tests (replaces rclpy Clock)."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float):
        self._now += dt


class WallClock:
    def now(self) -> float:
        import time
        return time.time()
