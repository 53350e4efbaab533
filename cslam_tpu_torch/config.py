"""Typed hierarchical configuration for cslam_tpu_torch.

Port of cslam_tpu/config.py with the same keys and defaults: a
reference deployment's parameters carry over unchanged. Key names mirror the reference's ROS 2 parameter namespaces
(frontend.* / backend.* / neighbor_management.* / evaluation.* /
visualization.*) declared in
Swarm-SLAM cslam/loop_closure_detection_node.py:20-44 and
Swarm-SLAM config/cslam/example.yaml, so that a reference deployment's
YAML transfers directly. A flat dict view (``to_flat_dict`` /
``from_flat_dict``) provides the ``params["frontend.similarity_threshold"]``
access style used throughout the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class FrontendConfig:
    # Loop-closure detection (loop_closure_detection_node.py:20-44)
    similarity_threshold: float = 0.9
    global_descriptor_technique: str = "cosplace"  # cosplace|netvlad|scancontext
    nn_checkpoint: str = ""  # ""/"disable" => random (testing); "shipped" => self-trained weights in models/weights/
    netvlad_pca_checkpoint: str = ""
    inter_robot_loop_closure_budget: int = 5
    inter_robot_detection_period_sec: float = 5.0
    nb_best_matches: int = 10
    image_crop_size: int = 376
    intra_loop_min_inbetween_keyframes: int = 10
    detection_publication_period_sec: float = 1.0
    detection_publication_max_elems_per_msg: int = 10
    # "int8": per-descriptor affine uint8 gossip encoding — 4x less DCN
    # volume than the reference's 4 B/float wire format, ~1e-3 cosine
    # error (comm/messages.py GlobalDescriptors)
    gossip_descriptor_quantization: str = "none"  # none|int8
    enable_intra_robot_loop_closures: bool = False
    global_descriptors_topic: str = "global_descriptors"
    inter_robot_matches_topic: str = "inter_robot_matches"
    enable_sparsification: bool = True
    use_vertex_cover_selection: bool = True
    # Minimum descriptor similarity for a candidate to ENTER budgeted
    # selection (0 = off). Distinct from similarity_threshold (the
    # detection gate): candidates just above the detection gate are
    # overwhelmingly unverifiable — in the reference package's 8-robot
    # sim missions every failed verification carried weight <= 0.70
    # while successful ones had median 0.87, so a floor between the two
    # spends the verification budget on candidates that can pass.
    # Below-floor candidates STAY in the pool (a later re-observation
    # can raise their weight via the max-weight dedup).
    candidate_selection_min_weight: float = 0.0
    sensor_type: str = "stereo"  # stereo|rgbd|lidar
    # Sensor handler (map_manager / rgbd_handler params)
    max_queue_size: int = 10
    pnp_min_inliers: int = 6
    # Loop-closure geometric verification: "3d3d" (Kabsch RANSAC on
    # backprojected points — needs depth on both sides), "pnp" (2D-3D
    # P3P RANSAC, ops/pnp.py — query side needs no depth; the
    # reference's RegistrationVis semantics, rgbd_handler.cpp:696), or
    # "auto" (PnP when the query frame's depth coverage is sparse).
    verification_mode: str = "auto"
    pnp_reprojection_error_px: float = 5.0
    # Local-feature pipeline: "classical" (corners + patch descriptors)
    # or "learned" (SuperPoint + LightGlue — the reference fork's
    # runtime path; weights via models/convert.py or models/onnx_import)
    features: str = "classical"
    # empty checkpoints -> the shipped self-trained weights
    # (models/zoo.py) when present; official converted checkpoints
    # (.pth/.onnx) take precedence when set
    superpoint_checkpoint: str = ""
    lightglue_checkpoint: str = ""
    # 0 = auto: the shipped checkpoint's depth (3) when it is used,
    # else the official superpoint_lightglue depth (9)
    lightglue_layers: int = 0
    lightglue_score_threshold: float = 0.1
    keyframe_generation_ratio_threshold: float = 1.0
    map_manager_process_period_ms: int = 100
    odom_topic: str = "odom"
    sensor_base_frame_id: str = "camera_link"
    # Descriptor dimensionality for the matching database (descriptor_dim of
    # the global descriptor model output).
    global_descriptor_dim: int = 512
    # Descriptor-database search: "auto" (the hand-written CUDA cosine
    # top-k kernel on a card, the exact search on the CPU), "exact"
    # (stable top-k over the full similarity row), "pallas" (the CUDA
    # kernel; its plain version on the CPU), or "approx" (exact in the
    # port: torch has no approximate top-k; matching/descriptor_db.py).
    nns_method: str = "auto"
    # Descriptor-database storage dtype: "float32" or "bfloat16" (halves
    # the database's device memory and traffic; the bf16 kernel runs
    # its products on the tensor cores; times in PERF.md).
    nns_storage: str = "float32"
    # Lidar keyframe spacing (lidar_handler_node.py keyframe distance gate)
    kf_distance_threshold: float = 1.0
    voxel_size: float = 0.5


@dataclass
class BackendConfig:
    pose_graph_optimization_start_period_ms: int = 500
    pose_graph_optimization_loop_period_ms: int = 100
    max_waiting_time_sec: float = 60.0
    enable_broadcast_tf_frames: bool = True
    # GNC robust PGO knobs (replaces GTSAM GncOptimizer defaults)
    gnc_barc_sq: float = 10.0  # inlier gate ~ chi2(0.99, 6)/2 on 0.5||r||^2
    gnc_mu_step: float = 1.4
    gnc_max_outer_iters: int = 100
    lm_max_iters: int = 10
    lm_init_lambda: float = 1e-4
    cg_max_iters: int = 100
    cg_tol: float = 1e-6
    prior_sigma: float = 1e-4  # gauge prior on first own pose
    # init each solve from the previous round's optimized values
    # (odometry-delta-chained for new poses); the reference re-solves
    # from raw odometry every round
    warm_start_optimization: bool = True


@dataclass
class NeighborManagementConfig:
    enable_neighbor_monitoring: bool = False
    max_heartbeat_delay_sec: float = 5.0
    init_delay_sec: float = 5.0
    heartbeat_period_sec: float = 0.5


@dataclass
class EvaluationConfig:
    enable_logs: bool = False
    log_folder: str = ""
    enable_gps_recording: bool = False
    gps_topic: str = "gps/fix"
    enable_sparsification_comparison: bool = False
    enable_simulated_rendezvous: bool = False
    rendezvous_schedule_file: str = ""


@dataclass
class VisualizationConfig:
    enable: bool = False
    publishing_period_ms: int = 1000


@dataclass
class SwarmConfig:
    """Top-level per-robot configuration."""

    robot_id: int = 0
    max_nb_robots: int = 1
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    neighbor_management: NeighborManagementConfig = field(
        default_factory=NeighborManagementConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    visualization: VisualizationConfig = field(
        default_factory=VisualizationConfig)

    # ------------------------------------------------------------------
    # Flat-dict interop (reference style params["frontend.xyz"])
    # ------------------------------------------------------------------
    _SECTIONS = ("frontend", "backend", "neighbor_management", "evaluation",
                 "visualization")

    def to_flat_dict(self) -> Dict[str, Any]:
        flat: Dict[str, Any] = {
            "robot_id": self.robot_id,
            "max_nb_robots": self.max_nb_robots,
        }
        for section in self._SECTIONS:
            cfg = getattr(self, section)
            for f in dataclasses.fields(cfg):
                key = f.name
                # reference spells the nested netvlad key with a dot
                if key == "netvlad_pca_checkpoint":
                    flat[f"{section}.netvlad.pca_checkpoint"] = getattr(cfg, key)
                else:
                    flat[f"{section}.{key}"] = getattr(cfg, key)
        return flat

    @classmethod
    def from_flat_dict(cls, params: Dict[str, Any]) -> "SwarmConfig":
        cfg = cls()
        for key, value in params.items():
            if key == "robot_id":
                cfg.robot_id = int(value)
            elif key == "max_nb_robots":
                cfg.max_nb_robots = int(value)
            elif "." in key:
                section, _, rest = key.partition(".")
                if rest == "netvlad.pca_checkpoint":
                    rest = "netvlad_pca_checkpoint"
                if section in cls._SECTIONS and hasattr(
                        getattr(cfg, section), rest):
                    setattr(getattr(cfg, section), rest, value)
        return cfg

    @classmethod
    def from_yaml(cls, path: str, robot_id: Optional[int] = None) -> "SwarmConfig":
        """Load from a reference-style YAML (ros__parameters layout or flat)."""
        import yaml  # lazy; only needed for file-based configs

        with open(path) as f:
            raw = yaml.safe_load(f)
        # unwrap /**: ros__parameters: if present
        if isinstance(raw, dict) and len(raw) == 1:
            inner = next(iter(raw.values()))
            if isinstance(inner, dict) and "ros__parameters" in inner:
                raw = inner["ros__parameters"]
        flat: Dict[str, Any] = {}

        def _flatten(prefix, node):
            for k, v in node.items():
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    _flatten(key + ".", v)
                else:
                    flat[key] = v

        _flatten("", raw)
        cfg = cls.from_flat_dict(flat)
        if robot_id is not None:
            cfg.robot_id = robot_id
        return cfg


def default_params(**overrides) -> Dict[str, Any]:
    """Flat param dict with reference defaults, for tests and scripts."""
    flat = SwarmConfig().to_flat_dict()
    flat.update(overrides)
    return flat
