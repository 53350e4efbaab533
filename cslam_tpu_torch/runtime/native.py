"""ctypes bindings of the C++ optimizer state machine and sensor sync.

Port of the `NativeStateMachine` and `NativeSensorSync` parts of
cslam_tpu/runtime/native.py. Each library is compiled from one source
of the repo's `native/` alone (`swarm_state.cpp`, `sensor_sync.cpp`:
standard headers only, no threads, no sockets) with g++ under a
timeout, at first use and never at import, into
`cslam_tpu_torch/_build/` under a name hashed from the source and the
flags. It is written to a temporary file and renamed into place, so
processes building at once do not collide. Nothing is written into
`native/`, and `make` is not run.

The reference's other bindings (TCP bus, logger, rendezvous) are not
ported yet.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "swarm_state.cpp"
SYNC_SOURCE = _PKG.parent / "native" / "sensor_sync.cpp"
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
# library name prefix and C signatures of each source
LIBRARIES = {SOURCE: ("libcslam_state", SIGNATURES),
             SYNC_SOURCE: ("libcslam_sync", SYNC_SIGNATURES)}


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for `source` and the flags lives."""
    h = hashlib.sha256()
    h.update(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
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
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", str(tmp)]
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
