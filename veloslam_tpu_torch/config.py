"""Single typed configuration tree for the whole engine.

A jax-free copy of veloslam_tpu/config.py (importing the original runs
the JAX package's __init__): every dataclass and default is the
original's, `MeshConfig` (the multi-device layout, read by
veloslam_tpu_torch.parallel) included, and tests/test_torch_host.py holds
them equal as `dataclasses.asdict`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from veloslam_tpu_torch import constants as C


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Which LiDAR and how to decode it.

    `model` selects the timing/beam layout: "hdl32", "vlp16" or "hdl64".
    """

    model: str = "hdl32"
    # Path to a Velodyne XML calibration file; None uses built-in tables.
    calibration_path: Optional[str] = None
    rpm: float = 600.0
    # Crop region (x0, x1, y0, y1, z0, z1) in sensor frame; None disables.
    crop_region: Optional[Tuple[float, float, float, float, float, float]] = None
    crop_inside: bool = False    # True: drop inside region; False: keep inside
    # Dual-return selection: None keeps both returns; "near"/"far"/
    # "high"/"low" keeps one member per pair.
    dual_return_filter: Optional[str] = None
    # Static bound on firings per revolution.
    max_firings_per_frame: int = C.MAX_FIRINGS_PER_FRAME
    # Laser selection: wire laser ids to decode; None enables all.
    laser_mask: Optional[Tuple[int, ...]] = None

    @property
    def n_lasers(self) -> int:
        return {"hdl32": 32, "vlp16": 16, "hdl64": 64}[self.model]

    def enabled_lasers(self):
        """(n_lasers,) bool mask from `laser_mask` (None → all True)."""
        import numpy as np
        if self.laser_mask is None:
            return None
        en = np.zeros(self.n_lasers, bool)
        en[list(self.laser_mask)] = True
        return en


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Decode / motion-compensation pipeline knobs."""

    # Packets per decode batch of the per-frame path.
    packets_per_batch: int = 512
    # "se3": full SE(3) per-point de-skew. "translation": translation-only.
    compensation: str = "se3"
    # Drop every (skip+1)-th firing block.
    points_skip: int = 0
    # In-memory frame cache capacity of the per-frame path.
    frame_cache_capacity: int = 200


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Scan-to-scan and scan-to-map registration."""

    method: str = "gicp"
    # Odometry voxel size (m).
    voxel_size: float = 0.5
    # Fixed voxel-table capacity per scan.
    scan_voxel_capacity: int = 8192
    # Rolling odometry map rows.
    rolling_map_capacity: int = 65536
    max_iterations: int = 16
    # Levenberg damping added to the 6x6 normal equations.
    damping: float = 1e-6
    huber_delta: float = 0.5
    # Reject correspondences whose point-to-plane distance exceeds this.
    max_correspondence_dist: float = 2.0
    # Minimum points per voxel for a valid Gaussian.
    min_points_per_voxel: int = 4
    # Planarity gate (λ2−λ3)/λ1 for point-to-plane voxels.
    min_planarity: float = 0.35
    # Points per scan fed to registration (subsampled, static shape).
    max_points: int = 16384
    # Health gates: correspondences a registration needs to be trusted.
    min_matched_points: int = 500
    min_matched_voxels: int = 50
    # Kernel variants of the JAX package; the port always runs its
    # normal-equations kernel and the dense index on the batched path.
    use_pallas: bool = False
    use_dense_index: bool = True
    # Re-run correspondence search every k GN iterations.
    reassociate_every: int = 8
    # Rolling-map forgetting factor per frame.
    map_decay: float = 0.98


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Patch-tiled voxel-Gaussian map."""

    voxel_size: float = 1.0
    patch_size_m: float = 100.0          # tile edge
    voxels_per_patch: int = 16384        # fixed capacity per patch block
    max_resident_patches: int = 16       # resident patch budget
    roi_range_m: float = C.ROI_RANGE_M


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph back end."""

    keyframe_translation_m: float = 2.0   # new keyframe after this motion
    keyframe_rotation_deg: float = 10.0
    loop_closure_radius_m: float = 15.0
    loop_closure_min_gap: int = 50        # keyframe-index separation
    max_keyframes: int = 1024             # keyframe ring capacity
    gn_iterations: int = 8
    damping: float = 1e-6
    # Appearance-based (scan-context) loop-closure proposal.
    use_scan_context: bool = True
    sc_min_score: float = 0.6             # cosine similarity gate
    # Verification budget per sweep (floor of the end-of-stream budget).
    max_closure_candidates_per_sweep: int = 8
    # Closure-verification voxel size (its coarse pass runs at 4x).
    verify_voxel_m: float = 1.0
    keyframes_per_closure_sweep: int = 10  # sweep cadence (keyframes)
    # Edge information diagonals (rot×3, trans×3).
    odom_edge_info: Tuple[float, ...] = (1e6,) * 3 + (100.0,) * 3
    closure_edge_info: Tuple[float, ...] = (1e4,) * 3 + (500.0,) * 3
    # Landmark layer: post detections per keyframe become pose-landmark
    # observations, Schur-eliminated in the solver.
    use_landmarks: bool = True
    landmark_cluster_radius_m: float = 1.2
    landmark_min_observations: int = 2
    # Observation information 1/sigma².
    landmark_obs_info: float = 8.0
    # Residual trim after the first landmark solve (0 disables).
    landmark_trim_residual_m: float = 1.0
    # Placement of the end-of-session solves in the JAX package (a TPU
    # workaround); the port solves on the pipeline's device.
    host_solve: bool = True
    host_solve_max_poses: int = 4096


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh / sharding layout: `data_axis` × `map_axis` ranks.

    Axes: "data" batches scans/packets, "map" shards map patches and
    pose-graph edges (veloslam_tpu_torch/parallel/mesh.py).
    """

    data_axis: int = 1
    map_axis: int = 1

    @property
    def n_devices(self) -> int:
        return self.data_axis * self.map_axis


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    registration: RegistrationConfig = dataclasses.field(
        default_factory=RegistrationConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SlamConfig":
        """Inverse of `dataclasses.asdict` (lists, as JSON gives tuples
        back, become tuples); a dict without "mesh" (the goldens keep
        none) takes the default layout."""
        def sub(klass, values):
            return klass(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in values.items()})
        return cls(sensor=sub(SensorConfig, d["sensor"]),
                   pipeline=sub(PipelineConfig, d["pipeline"]),
                   registration=sub(RegistrationConfig, d["registration"]),
                   map=sub(MapConfig, d["map"]),
                   graph=sub(GraphConfig, d["graph"]),
                   mesh=sub(MeshConfig, d.get("mesh", {})))
