"""Typed wire schema for inter-robot communication.

Port of cslam_tpu/comm/messages.py: the same dataclasses and the same
bytes on the wire (both packages decode what the other encodes,
including the int8 gossip encoding), so robots of either package can
share one bus. Capability parity with the reference's `cslam_common_interfaces` message
package (SURVEY §2 #30, inferred from usage at
global_descriptor_loop_closure_detection.py:11-16, gtsam_utils.cpp:34-161,
decentralized_pgo.h:16-27). Dataclasses with compact binary
serialization (struct + raw numpy arrays) for the swarm bus — replacing
ROS 2 IDL/DDS CDR encoding.
"""

import io
import struct
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

# ----------------------------------------------------------------------
# serialization helpers
# ----------------------------------------------------------------------


def _pack_array(buf: io.BytesIO, arr: np.ndarray):
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    buf.write(struct.pack("<I", arr.size))
    buf.write(arr.tobytes())


def _unpack_array(buf: io.BytesIO, shape=None) -> np.ndarray:
    (n,) = struct.unpack("<I", buf.read(4))
    arr = np.frombuffer(buf.read(4 * n), dtype=np.float32).copy()
    return arr.reshape(shape) if shape else arr


def _pack_ints(buf: io.BytesIO, vals):
    buf.write(struct.pack("<I", len(vals)))
    buf.write(np.asarray(vals, dtype=np.int32).tobytes())


def _unpack_ints(buf: io.BytesIO) -> List[int]:
    (n,) = struct.unpack("<I", buf.read(4))
    return np.frombuffer(buf.read(4 * n), dtype=np.int32).tolist()


class Message:
    """Base: subclasses define _FIELDS = [(name, kind)] with kind in
    {'i', 'f', 'b', 'ints', 'floats', 'pose', 'bytes'}."""
    _FIELDS: List[Tuple[str, str]] = []

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        for name, kind in self._FIELDS:
            v = getattr(self, name)
            if kind == "i":
                buf.write(struct.pack("<i", int(v)))
            elif kind == "f":
                buf.write(struct.pack("<f", float(v)))
            elif kind == "b":
                buf.write(struct.pack("<?", bool(v)))
            elif kind == "ints":
                _pack_ints(buf, v)
            elif kind == "floats":
                _pack_array(buf, np.asarray(v))
            elif kind == "pose":  # (R (3,3), t (3,)) as 12 floats
                R, t = v
                _pack_array(buf, np.concatenate(
                    [np.asarray(R).reshape(9), np.asarray(t).reshape(3)]))
            elif kind == "bytes":
                buf.write(struct.pack("<I", len(v)))
                buf.write(v)
            else:
                raise ValueError(kind)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes):
        buf = io.BytesIO(data)
        kwargs = {}
        for name, kind in cls._FIELDS:
            if kind == "i":
                (kwargs[name],) = struct.unpack("<i", buf.read(4))
            elif kind == "f":
                (kwargs[name],) = struct.unpack("<f", buf.read(4))
            elif kind == "b":
                (kwargs[name],) = struct.unpack("<?", buf.read(1))
            elif kind == "ints":
                kwargs[name] = _unpack_ints(buf)
            elif kind == "floats":
                kwargs[name] = _unpack_array(buf)
            elif kind == "pose":
                flat = _unpack_array(buf)
                kwargs[name] = (flat[:9].reshape(3, 3), flat[9:12])
            elif kind == "bytes":
                (n,) = struct.unpack("<I", buf.read(4))
                kwargs[name] = buf.read(n)
        return cls(**kwargs)


def _identity_pose():
    return (np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32))


@dataclass
class GlobalDescriptor(Message):
    keyframe_id: int = 0
    robot_id: int = 0
    descriptor: np.ndarray = field(default_factory=lambda: np.zeros(0))
    _FIELDS = [("keyframe_id", "i"), ("robot_id", "i"),
               ("descriptor", "floats")]


_QUANTIZED_SENTINEL = 0xFFFFFFFF


@dataclass
class GlobalDescriptors(Message):
    """Gossip container. `quantization="int8"` encodes each descriptor
    as per-descriptor affine uint8 (min + scale + 1 B/element) instead
    of 4 B/float — 4x less gossip volume than the reference's float wire
    format (4 B/float comm accounting, g_d_l_c_d.py:210-214) at a
    worst-case elementwise error of ptp/510 (~1e-3 cosine shift on
    unit-norm CNN descriptors, far below the 0.75 matching threshold's
    sensitivity). The float layout is unchanged, so both encodings
    coexist on one bus: the decoder dispatches on a count-field
    sentinel no float payload can produce."""

    descriptors: List[GlobalDescriptor] = field(default_factory=list)
    quantization: str = "none"

    def uses_int8_encoding(self) -> bool:
        """Whether to_bytes() will actually emit the int8 wire format.
        Mixed descriptor sizes in one chunk silently fall back to the
        float layout — comm accounting must ask THIS, not the
        `quantization` request field."""
        return (self.quantization == "int8" and bool(self.descriptors)
                and len({d.descriptor.size for d in self.descriptors}) == 1)

    def to_bytes(self):
        if self.uses_int8_encoding():
            return self._to_bytes_int8()
        buf = io.BytesIO()
        buf.write(struct.pack("<I", len(self.descriptors)))
        for d in self.descriptors:
            payload = d.to_bytes()
            buf.write(struct.pack("<I", len(payload)))
            buf.write(payload)
        return buf.getvalue()

    def _to_bytes_int8(self):
        buf = io.BytesIO()
        dim = self.descriptors[0].descriptor.size
        buf.write(struct.pack("<IBII", _QUANTIZED_SENTINEL, 1,
                              len(self.descriptors), dim))
        for d in self.descriptors:
            x = np.ascontiguousarray(d.descriptor, dtype=np.float32)
            minv = float(x.min())
            scale = float(x.max() - minv) / 255.0
            q = np.zeros(dim, np.uint8) if scale == 0.0 else np.clip(
                np.rint((x - minv) / scale), 0, 255).astype(np.uint8)
            buf.write(struct.pack("<iiff", d.keyframe_id, d.robot_id,
                                  scale, minv))
            buf.write(q.tobytes())
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        (n,) = struct.unpack("<I", buf.read(4))
        if n == _QUANTIZED_SENTINEL:
            (version,) = struct.unpack("<B", buf.read(1))
            if version != 1:
                raise ValueError(f"unknown descriptor encoding {version}")
            n, dim = struct.unpack("<II", buf.read(8))
            out = []
            for _ in range(n):
                kf, rid, scale, minv = struct.unpack("<iiff", buf.read(16))
                q = np.frombuffer(buf.read(dim), dtype=np.uint8)
                out.append(GlobalDescriptor(
                    keyframe_id=kf, robot_id=rid,
                    descriptor=minv + scale * q.astype(np.float32)))
            return cls(descriptors=out, quantization="int8")
        out = []
        for _ in range(n):
            (sz,) = struct.unpack("<I", buf.read(4))
            out.append(GlobalDescriptor.from_bytes(buf.read(sz)))
        return cls(descriptors=out)


@dataclass
class InterRobotMatch(Message):
    robot0_id: int = 0
    robot0_keyframe_id: int = 0
    robot1_id: int = 0
    robot1_keyframe_id: int = 0
    weight: float = 0.0
    _FIELDS = [("robot0_id", "i"), ("robot0_keyframe_id", "i"),
               ("robot1_id", "i"), ("robot1_keyframe_id", "i"),
               ("weight", "f")]


@dataclass
class InterRobotMatches(Message):
    robot_id: int = 0
    matches: List[InterRobotMatch] = field(default_factory=list)

    def to_bytes(self):
        buf = io.BytesIO()
        buf.write(struct.pack("<iI", self.robot_id, len(self.matches)))
        for m in self.matches:
            buf.write(m.to_bytes())
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        robot_id, n = struct.unpack("<iI", buf.read(8))
        matches = [InterRobotMatch.from_bytes(buf.read(20)) for _ in range(n)]
        return cls(robot_id=robot_id, matches=matches)


@dataclass
class LocalDescriptorsRequest(Message):
    keyframe_id: int = 0
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)
    _FIELDS = [("keyframe_id", "i"), ("matches_robot_id", "ints"),
               ("matches_keyframe_id", "ints")]


@dataclass
class LocalKeyframeMatch(Message):
    keyframe0_id: int = 0
    keyframe1_id: int = 0
    _FIELDS = [("keyframe0_id", "i"), ("keyframe1_id", "i")]


@dataclass
class InterRobotLoopClosure(Message):
    """Covariance rides along as the 6 diagonal entries [omega, v] of the
    registration estimate covariance (the reference carries a full
    gtsam covariance in the message and its PGO reads the diagonal,
    rgbd_handler.cpp:623/:703 + decentralized_pgo.cpp:343-348). All
    zeros = unknown -> ingestion falls back to the default noise."""
    robot0_id: int = 0
    robot0_keyframe_id: int = 0
    robot1_id: int = 0
    robot1_keyframe_id: int = 0
    success: bool = False
    pose: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)  # robot0_kf -> robot1_kf
    covariance_diag: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.float32))
    _FIELDS = [("robot0_id", "i"), ("robot0_keyframe_id", "i"),
               ("robot1_id", "i"), ("robot1_keyframe_id", "i"),
               ("success", "b"), ("pose", "pose"),
               ("covariance_diag", "floats")]


@dataclass
class IntraRobotLoopClosure(Message):
    keyframe0_id: int = 0
    keyframe1_id: int = 0
    success: bool = False
    pose: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    covariance_diag: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.float32))
    _FIELDS = [("keyframe0_id", "i"), ("keyframe1_id", "i"),
               ("success", "b"), ("pose", "pose"),
               ("covariance_diag", "floats")]


@dataclass
class KeyframeOdom(Message):
    """Keyframe odometry; optional GPS fix rides along
    (reference KeyframeOdom carries odom + gps, decentralized_pgo
    gps_data_ recording :284-287). covariance_diag: [omega, v] odometry
    covariance diagonal; zeros = unknown (the reference gates on
    covariance.front() != 0, decentralized_pgo.cpp:256-261)."""
    id: int = 0
    pose: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    gps: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))  # lat, lon, alt
    covariance_diag: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.float32))
    _FIELDS = [("id", "i"), ("pose", "pose"), ("gps", "floats"),
               ("covariance_diag", "floats")]


@dataclass
class LocalPointCloudDescriptors(Message):
    """Voxel-downsampled keyframe cloud for lidar geometric verification
    (reference LocalPointCloudDescriptors usage, lidar_handler_node.py)."""
    robot_id: int = 0
    keyframe_id: int = 0
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)
    points: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))

    def to_bytes(self):
        buf = io.BytesIO()
        buf.write(struct.pack("<ii", self.robot_id, self.keyframe_id))
        _pack_ints(buf, self.matches_robot_id)
        _pack_ints(buf, self.matches_keyframe_id)
        _pack_array(buf, self.points)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        rid, kid = struct.unpack("<ii", buf.read(8))
        mrid = _unpack_ints(buf)
        mkid = _unpack_ints(buf)
        pts = _unpack_array(buf).reshape(-1, 3)
        return cls(robot_id=rid, keyframe_id=kid, matches_robot_id=mrid,
                   matches_keyframe_id=mkid, points=pts)


@dataclass
class LocalImageDescriptors(Message):
    """Keyframe local features for visual geometric verification
    (reference LocalImageDescriptors: keypoints + fp16 descriptors + 3D
    points, rgbd_handler.cpp:566-590; descriptors travel as float16 to
    halve comm volume exactly like the reference)."""
    robot_id: int = 0
    keyframe_id: int = 0
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)
    keypoints: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32))
    descriptors: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float16))
    points3d: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))
    # depth-validity mask of points3d (1 B/kpt on the wire): the
    # 2D-3D (PnP) verification mode needs to know WHICH received
    # keypoints carry usable depth — the reference ships this
    # implicitly through rtabmap's keypoint3D validity. Empty =
    # legacy sender, receiver assumes all valid.
    valid3d: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.float32))
    # detector-validity mask (keypoints usable as 2D observations
    # regardless of depth); empty = fall back to valid3d
    valid2d: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.float32))
    # sender camera (fx, fy, cx, cy) so receivers can normalize the
    # pixel keypoints for PnP; zeros = unknown (PnP unavailable)
    intrinsics: tuple = (0.0, 0.0, 0.0, 0.0)

    def to_bytes(self):
        buf = io.BytesIO()
        buf.write(struct.pack("<ii", self.robot_id, self.keyframe_id))
        _pack_ints(buf, self.matches_robot_id)
        _pack_ints(buf, self.matches_keyframe_id)
        _pack_array(buf, self.keypoints)
        desc = np.ascontiguousarray(self.descriptors, dtype=np.float16)
        buf.write(struct.pack("<II", desc.shape[0],
                              desc.shape[1] if desc.ndim > 1 else 0))
        buf.write(desc.tobytes())
        _pack_array(buf, self.points3d)
        # appended (back-compatible) PnP-mode fields: masks travel as
        # 1 B/kpt uint8, intrinsics as 4 floats
        v3 = np.ascontiguousarray(
            np.asarray(self.valid3d) > 0.5).astype(np.uint8)
        v2 = np.ascontiguousarray(
            np.asarray(self.valid2d) > 0.5).astype(np.uint8)
        buf.write(struct.pack("<I", v3.shape[0]))
        buf.write(v3.tobytes())
        buf.write(struct.pack("<I", v2.shape[0]))
        buf.write(v2.tobytes())
        buf.write(struct.pack("<ffff", *[float(x)
                                         for x in self.intrinsics]))
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        rid, kid = struct.unpack("<ii", buf.read(8))
        mrid = _unpack_ints(buf)
        mkid = _unpack_ints(buf)
        kps = _unpack_array(buf).reshape(-1, 2)
        rows, cols = struct.unpack("<II", buf.read(8))
        desc = np.frombuffer(buf.read(2 * rows * cols),
                             dtype=np.float16).reshape(rows, cols).copy()
        pts = _unpack_array(buf).reshape(-1, 3)
        v3 = np.zeros((0,), np.float32)
        v2 = np.zeros((0,), np.float32)
        intr = (0.0, 0.0, 0.0, 0.0)
        head = buf.read(4)
        if len(head) == 4:  # legacy payloads end at points3d
            n3 = struct.unpack("<I", head)[0]
            v3 = np.frombuffer(buf.read(n3),
                               dtype=np.uint8).astype(np.float32)
            n2 = struct.unpack("<I", buf.read(4))[0]
            v2 = np.frombuffer(buf.read(n2),
                               dtype=np.uint8).astype(np.float32)
            intr = struct.unpack("<ffff", buf.read(16))
        return cls(robot_id=rid, keyframe_id=kid, matches_robot_id=mrid,
                   matches_keyframe_id=mkid, keypoints=kps,
                   descriptors=desc, points3d=pts, valid3d=v3,
                   valid2d=v2, intrinsics=intr)


@dataclass
class KeyframeRGB(Message):
    """Keyframe image for global-descriptor extraction (KeyframeRGB,
    rgbd_handler.cpp:730-763). Image travels as raw bytes + shape."""
    id: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0
    image_bytes: bytes = b""
    _FIELDS = [("id", "i"), ("height", "i"), ("width", "i"),
               ("channels", "i"), ("image_bytes", "bytes")]

    @property
    def image(self) -> np.ndarray:
        return np.frombuffer(self.image_bytes, dtype=np.uint8).reshape(
            self.height, self.width, self.channels)

    @classmethod
    def from_image(cls, kf_id: int, image: np.ndarray):
        image = np.ascontiguousarray(image, dtype=np.uint8)
        if image.ndim == 2:
            image = image[..., None]
        return cls(id=kf_id, height=image.shape[0], width=image.shape[1],
                   channels=image.shape[2], image_bytes=image.tobytes())


@dataclass
class Heartbeat(Message):
    origin_robot_id: int = 0
    _FIELDS = [("origin_robot_id", "i")]


@dataclass
class ReferenceFrames(Message):
    """The reference-frame/TF chain other components consume (reference
    broadcast_tf_callback + reference_frame_per_robot publisher,
    decentralized_pgo.cpp:744-851): origin map -> robot map ->
    latest-optimized -> current(odometry delta), plus the composed
    current pose in the origin frame (the reference's PoseStamped
    optimized_pose_estimate)."""
    robot_id: int = 0
    origin_robot_id: int = 0
    origin_to_first: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    latest_optimized: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    odom_delta: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    current_in_origin: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    _FIELDS = [("robot_id", "i"), ("origin_robot_id", "i"),
               ("origin_to_first", "pose"), ("latest_optimized", "pose"),
               ("odom_delta", "pose"), ("current_in_origin", "pose")]


@dataclass
class RobotIds(Message):
    ids: List[int] = field(default_factory=list)
    _FIELDS = [("ids", "ints")]


@dataclass
class RobotIdsAndOrigin(Message):
    ids: List[int] = field(default_factory=list)
    origins: List[int] = field(default_factory=list)
    _FIELDS = [("ids", "ints"), ("origins", "ints")]


@dataclass
class PoseGraphValue(Message):
    robot_id: int = 0
    keyframe_id: int = 0
    pose: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    _FIELDS = [("robot_id", "i"), ("keyframe_id", "i"), ("pose", "pose")]


@dataclass
class PoseGraphEdge(Message):
    key_from: Tuple[int, int] = (0, 0)
    key_to: Tuple[int, int] = (0, 0)
    measurement: Tuple[np.ndarray, np.ndarray] = field(
        default_factory=_identity_pose)
    noise_std: np.ndarray = field(
        default_factory=lambda: np.ones(6, np.float32))

    def to_bytes(self):
        buf = io.BytesIO()
        buf.write(struct.pack("<iiii", *self.key_from, *self.key_to))
        _pack_array(buf, np.concatenate(
            [np.asarray(self.measurement[0]).reshape(9),
             np.asarray(self.measurement[1]).reshape(3)]))
        _pack_array(buf, self.noise_std)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        a, b, c, d = struct.unpack("<iiii", buf.read(16))
        flat = _unpack_array(buf)
        noise = _unpack_array(buf)
        return cls(key_from=(a, b), key_to=(c, d),
                   measurement=(flat[:9].reshape(3, 3), flat[9:12]),
                   noise_std=noise)


@dataclass
class PoseGraph(Message):
    """Per-robot pose graph exchanged during collection
    (decentralized_pgo.cpp:417-475)."""
    robot_id: int = 0
    origin_robot_id: int = 0
    values: List[PoseGraphValue] = field(default_factory=list)
    edges: List[PoseGraphEdge] = field(default_factory=list)
    connected_robots: List[int] = field(default_factory=list)

    def to_bytes(self):
        buf = io.BytesIO()
        buf.write(struct.pack("<ii", self.robot_id, self.origin_robot_id))
        _pack_ints(buf, self.connected_robots)
        buf.write(struct.pack("<I", len(self.values)))
        for v in self.values:
            payload = v.to_bytes()
            buf.write(struct.pack("<I", len(payload)))
            buf.write(payload)
        buf.write(struct.pack("<I", len(self.edges)))
        for e in self.edges:
            payload = e.to_bytes()
            buf.write(struct.pack("<I", len(payload)))
            buf.write(payload)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        rid, oid = struct.unpack("<ii", buf.read(8))
        connected = _unpack_ints(buf)
        (nv,) = struct.unpack("<I", buf.read(4))
        values = []
        for _ in range(nv):
            (sz,) = struct.unpack("<I", buf.read(4))
            values.append(PoseGraphValue.from_bytes(buf.read(sz)))
        (ne,) = struct.unpack("<I", buf.read(4))
        edges = []
        for _ in range(ne):
            (sz,) = struct.unpack("<I", buf.read(4))
            edges.append(PoseGraphEdge.from_bytes(buf.read(sz)))
        return cls(robot_id=rid, origin_robot_id=oid, values=values,
                   edges=edges, connected_robots=connected)


@dataclass
class OptimizationResult(Message):
    success: bool = False
    origin_robot_id: int = 0
    estimates: List[PoseGraphValue] = field(default_factory=list)

    def to_bytes(self):
        buf = io.BytesIO()
        buf.write(struct.pack("<?i", self.success, self.origin_robot_id))
        buf.write(struct.pack("<I", len(self.estimates)))
        for v in self.estimates:
            payload = v.to_bytes()
            buf.write(struct.pack("<I", len(payload)))
            buf.write(payload)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        buf = io.BytesIO(data)
        success, oid = struct.unpack("<?i", buf.read(5))
        (n,) = struct.unpack("<I", buf.read(4))
        est = []
        for _ in range(n):
            (sz,) = struct.unpack("<I", buf.read(4))
            est.append(PoseGraphValue.from_bytes(buf.read(sz)))
        return cls(success=success, origin_robot_id=oid, estimates=est)


@dataclass
class KeyValue(Message):
    """Metrics log record (diagnostic_msgs/KeyValue equivalent)."""
    key: bytes = b""
    value: bytes = b""
    _FIELDS = [("key", "bytes"), ("value", "bytes")]
