"""Pose-graph state as fixed-capacity device arrays.

Port of veloslam_tpu/graph/posegraph.py::GraphArrays: keyframe poses and
factors in static-shape tensors with validity counts, so one solver
serves any graph up to capacity.  Factors: pose-pose edges (odometry and
loop closures; relative-pose measurement with diagonal information (6,))
and pose-landmark observations (information (3,)); the pose-only solver
(graph.optimize.solve) reads the edges only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GraphArrays(NamedTuple):
    """Device view of the graph (static shapes)."""

    q: torch.Tensor            # (K, 4) keyframe orientations
    t: torch.Tensor            # (K, 3) keyframe positions
    n_poses: torch.Tensor      # () int32
    e_i: torch.Tensor          # (E,) int32 edge source keyframe
    e_j: torch.Tensor          # (E,) int32 edge target keyframe
    e_q: torch.Tensor          # (E, 4) measured relative rotation
    e_t: torch.Tensor          # (E, 3) measured relative translation
    e_info: torch.Tensor       # (E, 6) diagonal information
    e_valid: torch.Tensor      # (E,) bool
    l_pos: torch.Tensor        # (M, 3) landmark positions
    n_landmarks: torch.Tensor  # () int32
    o_i: torch.Tensor          # (O,) int32 observing keyframe
    o_l: torch.Tensor          # (O,) int32 observed landmark
    o_z: torch.Tensor          # (O, 3) measurement in keyframe frame
    o_info: torch.Tensor       # (O, 3) diagonal information
    o_valid: torch.Tensor      # (O,) bool
