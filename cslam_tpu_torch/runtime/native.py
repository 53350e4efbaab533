"""ctypes binding of the C++ optimizer state machine.

Port of the `NativeStateMachine` part of cslam_tpu/runtime/native.py.
The library is compiled from the repo's `native/swarm_state.cpp` alone
(standard headers only, no threads, no sockets) with g++ under a
timeout, at first use and never at import, into
`cslam_tpu_torch/_build/` under a name hashed from the source and the
flags. It is written to a temporary file and renamed into place, so
processes building at once do not collide. Nothing is written into
`native/`, and `make` is not run.

The reference's other bindings (TCP bus, logger, rendezvous, sensor
sync) are not ported yet.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "swarm_state.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
BUILD_TIMEOUT_S = 120

_lib = None

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


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcslam_state_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not there yet; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}) on {SOURCE}:"
                               f"\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


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
