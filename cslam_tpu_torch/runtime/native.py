"""ctypes bindings of the repo's C++ runtime: the TCP bus, the metrics
logger, the rendezvous schedule, the optimizer state machine and the
sensor sync.

Port of cslam_tpu/runtime/native.py. Each library is compiled from one
source of the repo's `native/` alone (`bus.cpp`, `logger.cpp`,
`rendezvous.cpp`, `swarm_state.cpp`, `sensor_sync.cpp`: standard and
POSIX headers only, no cross-includes) with g++ under a timeout, at
first use and never at import, into `cslam_tpu_torch/_build/` under a
name hashed from the source and the flags used for it (the bus and the
logger run threads or locks and take `-pthread`). It is written to a
temporary file and renamed into place, so processes building at once do
not collide. Nothing is written into `native/`, and `make` is not run.

`NativeBus` has the interface of comm.bus.InProcessBus, so the whole
stack (loop-closure detection, decentralized PGO) runs unchanged over
real TCP between robot processes or hosts; its frames are the
reference's, so a port robot and a reference robot share one swarm.
"""

import ctypes
import fnmatch
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Tuple

from cslam_tpu_torch.comm.bus import Publisher

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "swarm_state.cpp"
SYNC_SOURCE = _PKG.parent / "native" / "sensor_sync.cpp"
BUS_SOURCE = _PKG.parent / "native" / "bus.cpp"
LOGGER_SOURCE = _PKG.parent / "native" / "logger.cpp"
RENDEZVOUS_SOURCE = _PKG.parent / "native" / "rendezvous.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
BUILD_TIMEOUT_S = 120

_libs = {}

_V = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of native/swarm_state.cpp: name -> (argtypes, restype)
SIGNATURES = {
    "cslam_state_create": ([_I, _D], _V),
    "cslam_state_destroy": ([_V], None),
    "cslam_state_get": ([_V], _I),
    "cslam_state_is_optimizer": ([_V], _I),
    "cslam_state_is_waiting": ([_V], _I),
    "cslam_state_force": ([_V, _I], None),
    "cslam_state_set_origin": ([_V, _I], None),
    "cslam_state_set_max_waiting": ([_V, _D], None),
    "cslam_state_set_has_odometry": ([_V, _I], None),
    "cslam_state_is_broker": ([_V, _IP, _I], _I),
    "cslam_state_start_waiting": ([_V, _D], None),
    "cslam_state_end_waiting": ([_V], None),
    "cslam_state_check_timeout": ([_V, _D], _I),
    "cslam_state_on_neighbors": ([_V, _IP, _IP, _I], None),
    "cslam_state_set_neighbors": ([_V, _IP, _IP, _I], None),
    "cslam_state_on_pose_graph": ([_V, _I], _I),
    "cslam_state_on_collection_tick": ([_V, _D], _I),
    "cslam_state_on_optimization_started": ([_V], None),
    "cslam_state_on_optimization_done": ([_V], None),
}
_U64P = ctypes.POINTER(ctypes.c_uint64)
_DP = ctypes.POINTER(ctypes.c_double)
# C signatures of native/sensor_sync.cpp
SYNC_SIGNATURES = {
    "cslam_sync_create": ([_I, _D, _I, _D], _V),
    "cslam_sync_destroy": ([_V], None),
    "cslam_sync_push": ([_V, _I, _D, ctypes.c_uint64], None),
    "cslam_sync_push_odom": ([_V, _D, ctypes.c_uint64], None),
    "cslam_sync_take": ([_V, _U64P, _DP], _I),
    "cslam_sync_lookup_odom": ([_V, _D, _U64P, _DP], _I),
}
_S = ctypes.c_char_p
_U32P = ctypes.POINTER(ctypes.c_uint32)
# C signatures of native/bus.cpp
BUS_SIGNATURES = {
    "cslam_bus_create": ([_I, _I, _I, _S], _V),
    "cslam_bus_publish": ([_V, _S, _S, _I], _I),
    "cslam_bus_poll": ([_V, _S, _I, _S, _I, _I], _I),
    "cslam_bus_front_sizes": ([_V, _U32P, _U32P], _I),
    "cslam_bus_sent_bytes": ([_V], ctypes.c_uint64),
    "cslam_bus_received_bytes": ([_V], ctypes.c_uint64),
    "cslam_bus_destroy": ([_V], None),
}
# C signatures of native/logger.cpp
LOGGER_SIGNATURES = {
    "cslam_logger_create": ([_S], _V),
    "cslam_logger_log_info": ([_V, _S, _S], None),
    "cslam_logger_start_timer": ([_V], None),
    "cslam_logger_stop_timer": ([_V], _D),
    "cslam_logger_log_pose_timestamp": ([_V, _I, _I, ctypes.c_long,
                                         ctypes.c_long], None),
    "cslam_logger_log_gps": ([_V, _I, _D, _D, _D], None),
    "cslam_logger_log_match": ([_V, _S, _I, _I, _I, _I, _D], None),
    "cslam_logger_clear_matches": ([_V, _S], None),
    "cslam_logger_write_logs": ([_V], _I),
    "cslam_logger_destroy": ([_V], None),
}
# C signatures of native/rendezvous.cpp
RENDEZVOUS_SIGNATURES = {
    "cslam_rendezvous_create": ([_S, _I, _I], _V),
    "cslam_rendezvous_is_alive": ([_V, _D], _I),
    "cslam_rendezvous_destroy": ([_V], None),
}
# library name prefix, C signatures and flags beyond CXX_FLAGS of each
# source; the bus's reader threads and acceptor, and the logger's lock,
# need -pthread (native/Makefile links everything with it)
LIBRARIES = {
    SOURCE: ("libcslam_state", SIGNATURES, []),
    SYNC_SOURCE: ("libcslam_sync", SYNC_SIGNATURES, []),
    BUS_SOURCE: ("libcslam_bus", BUS_SIGNATURES, ["-pthread"]),
    LOGGER_SOURCE: ("libcslam_logger", LOGGER_SIGNATURES, ["-pthread"]),
    RENDEZVOUS_SOURCE: ("libcslam_rendezvous", RENDEZVOUS_SIGNATURES, []),
}


def _flags(source: Path) -> List[str]:
    return CXX_FLAGS + LIBRARIES[source][2]


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for `source` and its flags lives."""
    h = hashlib.sha256()
    h.update(source.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{LIBRARIES[source][0]}_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source`'s library if it is not there yet; returns its
    path."""
    path = library_path(source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_flags(source), str(source), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}) on {source}:"
                               f"\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def _load(source: Path = SOURCE):
    if source not in _libs:
        lib = ctypes.CDLL(str(build(source)))
        for name, (argtypes, restype) in LIBRARIES[source][1].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[source] = lib
    return _libs[source]


def _ints(vals):
    return (ctypes.c_int * len(vals))(*vals)


class NativeStateMachine:
    """C++ optimizer state machine + elections (native/swarm_state.cpp),
    the control core of the reference's C++ DecentralizedPGO."""

    IDLE = 0
    WAITING_FOR_NEIGHBORS_INFO = 1
    POSEGRAPH_COLLECTION = 2
    WAITING_FOR_NEIGHBORS_POSEGRAPHS = 3
    START_OPTIMIZATION = 4
    OPTIMIZATION = 5

    def __init__(self, robot_id: int, max_waiting_time_sec: float):
        self._lib = _load()
        self._handle = self._lib.cslam_state_create(
            robot_id, float(max_waiting_time_sec))

    @property
    def state(self) -> int:
        return self._lib.cslam_state_get(self._handle)

    def force(self, state: int):
        self._lib.cslam_state_force(self._handle, int(state))

    def set_origin(self, origin: int):
        self._lib.cslam_state_set_origin(self._handle, origin)

    def set_max_waiting(self, seconds: float):
        self._lib.cslam_state_set_max_waiting(self._handle, float(seconds))

    def set_has_odometry(self, has: bool):
        self._lib.cslam_state_set_has_odometry(self._handle, 1 if has else 0)

    def is_optimizer(self) -> bool:
        return bool(self._lib.cslam_state_is_optimizer(self._handle))

    def is_broker(self, alive_other_ids) -> bool:
        return bool(self._lib.cslam_state_is_broker(
            self._handle, _ints(alive_other_ids), len(alive_other_ids)))

    def start_waiting(self, now: float):
        self._lib.cslam_state_start_waiting(self._handle, now)

    def end_waiting(self):
        self._lib.cslam_state_end_waiting(self._handle)

    def is_waiting(self) -> bool:
        return bool(self._lib.cslam_state_is_waiting(self._handle))

    def check_timeout(self, now: float) -> bool:
        return bool(self._lib.cslam_state_check_timeout(self._handle, now))

    def on_neighbors(self, ids, origins):
        self._lib.cslam_state_on_neighbors(self._handle, _ints(ids),
                                           _ints(origins), len(ids))

    def set_neighbors(self, ids, origins):
        self._lib.cslam_state_set_neighbors(self._handle, _ints(ids),
                                            _ints(origins), len(ids))

    def on_pose_graph(self, robot_id: int) -> bool:
        return bool(self._lib.cslam_state_on_pose_graph(self._handle,
                                                        robot_id))

    def on_collection_tick(self, now: float) -> int:
        return self._lib.cslam_state_on_collection_tick(self._handle, now)

    def on_optimization_started(self):
        self._lib.cslam_state_on_optimization_started(self._handle)

    def on_optimization_done(self):
        self._lib.cslam_state_on_optimization_done(self._handle)

    def close(self):
        if self._handle:
            self._lib.cslam_state_destroy(self._handle)
            self._handle = None


class NativeSensorSync:
    """C++ approximate-time synchronizer + odometry cache
    (native/sensor_sync.cpp, the RGB-D / stereo handler's sync core).
    Payloads are tracked as integer handles; the caller owns the data."""

    def __init__(self, n_streams: int = 2, slop: float = 0.02,
                 max_queue: int = 10, odom_slop: float = 0.03):
        self._lib = _load(SYNC_SOURCE)
        self.n_streams = n_streams
        self._handle = self._lib.cslam_sync_create(
            int(n_streams), float(slop), int(max_queue), float(odom_slop))

    def push(self, stream: int, stamp: float, payload_id: int):
        if not 0 <= stream < self.n_streams:
            raise ValueError(f"stream {stream} not in [0, {self.n_streams})")
        self._lib.cslam_sync_push(self._handle, int(stream), float(stamp),
                                  int(payload_id))

    def push_odom(self, stamp: float, payload_id: int):
        self._lib.cslam_sync_push_odom(self._handle, float(stamp),
                                       int(payload_id))

    def take(self):
        """(stamp, [payload ids]) of the next synchronized tuple, or
        None."""
        handles = (ctypes.c_uint64 * self.n_streams)()
        stamp = ctypes.c_double()
        if self._lib.cslam_sync_take(self._handle, handles,
                                     ctypes.byref(stamp)):
            return stamp.value, list(handles)
        return None

    def lookup_odom(self, stamp: float):
        """Nearest odometry (payload_id, stamp) within the slop, else
        None."""
        payload = ctypes.c_uint64()
        out_stamp = ctypes.c_double()
        if self._lib.cslam_sync_lookup_odom(self._handle, float(stamp),
                                            ctypes.byref(payload),
                                            ctypes.byref(out_stamp)):
            return payload.value, out_stamp.value
        return None

    def close(self):
        if self._handle:
            self._lib.cslam_sync_destroy(self._handle)
            self._handle = None


class NativeBus:
    """TCP full-mesh bus (native/bus.cpp) with the InProcessBus
    interface. Messages must implement to_bytes(); subscribe() registers
    (pattern, type, callback) and spin_once() drains the native queue,
    deserializing per topic. `close()` stops the bus's acceptor and
    reader threads and closes its sockets."""

    _MAX_MSG = 1 << 24

    def __init__(self, robot_id: int, n_robots: int, base_port: int = 17700,
                 hosts: str = ""):
        self._lib = _load(BUS_SOURCE)
        self.robot_id = robot_id
        self._handle = self._lib.cslam_bus_create(
            robot_id, n_robots, base_port, hosts.encode())
        if not self._handle:
            raise RuntimeError(
                f"failed to bind bus port {base_port + robot_id}")
        self._subs: List[Tuple[str, type, Callable]] = []
        self._topic_buf = ctypes.create_string_buffer(1024)
        self._data_buf = ctypes.create_string_buffer(self._MAX_MSG)

    def resolve(self, topic: str) -> str:
        if topic.startswith("/"):
            return topic
        return f"/r{self.robot_id}/{topic}"

    def create_publisher(self, topic: str) -> Publisher:
        # a resolved topic is absolute, so publish() keeps it as it is
        return Publisher(self, self.resolve(topic))

    def _publish_resolved(self, topic: str, msg):
        payload = msg if isinstance(msg, bytes) else msg.to_bytes()
        self._lib.cslam_bus_publish(self._handle, topic.encode(), payload,
                                    len(payload))

    def publish(self, topic: str, msg):
        self._publish_resolved(self.resolve(topic), msg)

    def subscribe(self, topic: str, callback: Callable, msg_type=None):
        """msg_type: Message subclass for deserialization; None delivers
        raw bytes."""
        self._subs.append((self.resolve(topic), msg_type, callback))

    def _grow_for_front(self) -> bool:
        """Resize buffers to fit the frame at the queue front (poll
        returned -2). Without this, one oversized message would wedge the
        bus forever (frames stay queued in FIFO order)."""
        tlen = ctypes.c_uint32()
        plen = ctypes.c_uint32()
        if self._lib.cslam_bus_front_sizes(
                self._handle, ctypes.byref(tlen), ctypes.byref(plen)) != 0:
            return False
        if tlen.value + 1 > len(self._topic_buf):
            self._topic_buf = ctypes.create_string_buffer(tlen.value + 1)
        if plen.value > len(self._data_buf):
            self._data_buf = ctypes.create_string_buffer(plen.value)
        return True

    def spin_once(self, timeout_ms: int = 0, max_msgs: int = 1000) -> int:
        delivered = 0
        for _ in range(max_msgs):
            n = self._lib.cslam_bus_poll(
                self._handle, self._topic_buf, len(self._topic_buf),
                self._data_buf, len(self._data_buf),
                timeout_ms if delivered == 0 else 0)
            if n == -2:
                if not self._grow_for_front():
                    break
                continue
            if n < 0:
                break
            topic = self._topic_buf.value.decode()
            raw = self._data_buf.raw[:n]
            for pattern, msg_type, callback in self._subs:
                if pattern == topic or fnmatch.fnmatch(topic, pattern):
                    callback(msg_type.from_bytes(raw)
                             if msg_type is not None else raw)
            delivered += 1
        return delivered

    @property
    def sent_bytes(self) -> int:
        return self._lib.cslam_bus_sent_bytes(self._handle)

    @property
    def received_bytes(self) -> int:
        return self._lib.cslam_bus_received_bytes(self._handle)

    def close(self):
        if self._handle:
            self._lib.cslam_bus_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeLogger:
    """C++ metrics sink (native/logger.cpp, the reference Logger's
    counterpart): metrics.csv, pose_timestamps.csv, gps.csv and named
    match streams under `folder`."""

    def __init__(self, folder: str):
        self._lib = _load(LOGGER_SOURCE)
        os.makedirs(folder, exist_ok=True)
        self._handle = self._lib.cslam_logger_create(folder.encode())
        self.folder = folder

    def log_info(self, key: str, value):
        self._lib.cslam_logger_log_info(self._handle, key.encode(),
                                        str(value).encode())

    def start_timer(self):
        self._lib.cslam_logger_start_timer(self._handle)

    def stop_timer(self) -> float:
        return self._lib.cslam_logger_stop_timer(self._handle)

    def log_pose_timestamp(self, robot_id, keyframe_id, sec, nanosec):
        self._lib.cslam_logger_log_pose_timestamp(self._handle, robot_id,
                                                  keyframe_id, sec, nanosec)

    def log_gps(self, keyframe_id, lat, lon, alt):
        self._lib.cslam_logger_log_gps(self._handle, keyframe_id, lat, lon,
                                       alt)

    def log_matches(self, stream: str, edges):
        """Replace a named match CSV stream (reference
        spectral_matches.csv, logger.cpp:174-191). `edges` are
        EdgeInterRobot-likes with robot0/robot1 ids+keyframes and a
        weight."""
        self._lib.cslam_logger_clear_matches(self._handle, stream.encode())
        for e in edges:
            self._lib.cslam_logger_log_match(
                self._handle, stream.encode(), int(e.robot0_id),
                int(e.robot0_keyframe_id), int(e.robot1_id),
                int(e.robot1_keyframe_id), float(e.weight))

    def write_logs(self):
        return self._lib.cslam_logger_write_logs(self._handle)

    # hooks used by DecentralizedPGO (graph logging stays in Python where
    # the arrays live; the C++ side persists scalar metrics)
    def add_pose_graph_log_info(self, msg):
        self.log_info("last_received_pose_graph_robot", msg.robot_id)
        self.log_info("last_received_pose_graph_edges", len(msg.edges))

    def log_initial_global_pose_graph(self, fg):
        self.log_info("initial_graph_nodes", fg.num_nodes)
        self.log_info("initial_graph_factors", fg.num_factors)

    def log_optimized_global_pose_graph(self, fg, cost, robot_id):
        self.log_info("total_error", cost)
        self.log_info("optimizer_robot_id", robot_id)

    def close(self):
        if self._handle:
            self._lib.cslam_logger_destroy(self._handle)
            self._handle = None


class NativeRendezvous:
    """C++ schedule-driven liveness (native/rendezvous.cpp, the
    reference SimulatedRendezVous's counterpart). A missing schedule file
    leaves the robot alive."""

    def __init__(self, schedule_file: str, robot_id: int,
                 enabled: bool = True):
        self._lib = _load(RENDEZVOUS_SOURCE)
        self._handle = self._lib.cslam_rendezvous_create(
            schedule_file.encode(), robot_id, 1 if enabled else 0)

    def is_alive(self, now: float) -> bool:
        return bool(self._lib.cslam_rendezvous_is_alive(self._handle, now))

    def close(self):
        if self._handle:
            self._lib.cslam_rendezvous_destroy(self._handle)
            self._handle = None
