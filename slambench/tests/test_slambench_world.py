"""The reference's own decode places every return on the world, and its
judge of the map and the landmarks reads a map made of the true points
as sound and a displaced or empty one as off (CPU, short drives without
range noise)."""

import numpy as np
import pytest

from slambench.gen import drive, scene
from slambench.gen import sensor as S
from slambench.reference import world as W

def _drive(model, seconds, tmp_path):
    calib = S.unit_calib(model, 64, 2.0, 0.05) if model == "hdl64" else None
    wd = scene.World.demo(3, extent=40.0, n_posts=40, n_walls=16)
    path = scene.Circle(8.0, 8.0)
    d = drive.generate(seconds, model, wd, path, calib=calib)
    xml = None
    if calib is not None:
        xml = str(tmp_path / "db.xml")
        S.write_db_xml(calib, xml)
    rot, vert = W.laser_angles(model, xml)
    return wd, path, d, W.Returns(d.packets, d.pkt_times_us, model), \
        rot, vert


@pytest.mark.parametrize("model", ["hdl32", "hdl64"])
def test_decoded_returns_lie_on_the_world(model, tmp_path):
    """Within 5 mm: the 2 mm range code rounds by 1 mm, and the decode
    steps each laser's azimuth by the packet's own block-to-block step,
    where the generator used the nominal one (up to 0.6 of a tick)."""
    wd, path, d, r, rot, vert = _drive(model, 0.3, tmp_path)
    p = W.world_points(r, 0, len(r.az), rot, vert, path,
                       int(d.ins_t_us[0]), "cpu").numpy()
    assert len(p) > 100_000
    dist = np.minimum(np.abs(p[:, 2]), W.structure_distance(wd, p))
    assert dist.max() <= 0.005


def _true_map(points: np.ndarray, vs: float = 1.0):
    keys, inv, cnt = np.unique(np.floor(points / vs).astype(np.int64),
                               axis=0, return_inverse=True,
                               return_counts=True)
    s = np.zeros((len(keys), 3))
    np.add.at(s, inv.reshape(-1), points)
    return s / cnt[:, None], cnt.astype(np.float64)


def test_judge_sound_displaced_and_empty(tmp_path, monkeypatch):
    # A second of drive shows no post as well as the cells' 20 s do.
    monkeypatch.setattr(W, "SEEN_RETURNS", 100)
    monkeypatch.setattr(W, "SEEN_KEYFRAMES", 3)
    wd, path, d, r, rot, vert = _drive("hdl32", 1.0, tmp_path)
    t0 = int(d.ins_t_us[0])
    kf = r.open_t[:-1]
    ref = W.keyframe_reference(r, kf, rot, vert, wd, path, t0, 1.0, "cpu")
    assert len(ref["voxels"]) > 100
    seen = ref["post_keyframes"] >= W.SEEN_KEYFRAMES
    assert seen.sum() >= 1
    pts = np.concatenate([
        W.world_points(r, int(a), int(b), rot, vert, path, t0, "cpu").numpy()
        for a, b in zip(r.opens[:-1], r.opens[1:])])
    lift = 2.0                        # the program's frame starts at z 0
    means, counts = _true_map(pts - [0.0, 0.0, lift])
    out = {"times_us": kf[:1], "positions": np.zeros((1, 3)),
           "map_means": means, "map_counts": counts,
           "landmarks": np.c_[wd.posts[seen, :2], np.zeros(seen.sum())]}
    rules = {"voxel_m": 1.0, "landmark_radius_m": 1.2}
    nums, diag = W.judge(out, ref, wd, path, t0, rules)
    assert diag["height_lift_m"] == pytest.approx(lift)
    assert nums["map_off_m"] < 0.5
    assert nums["map_voxels_missing"] == 0
    assert nums["landmark_off_max_m"] == 0.0
    assert nums["posts_missed_share"] == 0.0

    shifted = dict(out, map_means=means + [3.0, 0.0, 0.0],
                   landmarks=out["landmarks"] + [3.0, 0.0, 0.0])
    nums, _ = W.judge(shifted, ref, wd, path, t0, rules)
    assert nums["map_off_m"] > 1.0
    assert nums["map_voxels_missing"] > 0.2 * len(ref["voxels"])
    assert nums["landmark_off_max_m"] > 1.0
    assert nums["posts_missed_share"] == 1.0

    empty = dict(out, map_means=np.zeros((0, 3)), map_counts=np.zeros(0),
                 landmarks=np.zeros((0, 3)))
    nums, _ = W.judge(empty, ref, wd, path, t0, rules)
    assert nums["map_off_m"] == float("inf")
    assert nums["map_voxels_missing"] == len(ref["voxels"])
    assert nums["posts_missed_share"] == 1.0
