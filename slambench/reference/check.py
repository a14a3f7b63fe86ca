"""The numbers that decide `correct`, each judged against the reference.

For every pass (one user run) of the window, the program's answers are:
the frames (start time and pose of each), and for full SLAM the
keyframes (their times) and the accepted loop closures (the two keyframes
and the measured relative pose).  The reference gives the frame schedule
the packets make (`frames.schedule`) and the true pose at any time
(`truth.poses`).  The numbers:

  frames_bad       frames of the schedule that no program frame starts
                   within TIME_TOL_US of, plus program frames that start
                   at no frame of the schedule (every pass; exact: 0)
  drift_max_m      the largest error of the program's displacement over
                   `drift_lag_s` (the frame lag nearest it) against the
                   true displacement, horizontal, in the world frame: how
                   fast the poses wander from the world, whatever they
                   wandered before
  ate_max_m        the largest horizontal distance of a frame's position
                   from the truth (the program's frame is the INS frame,
                   which starts on the truth)
  keyframes_bad    keyframes that start at no program frame, plus
                   consecutive keyframes whose true poses lie more than
                   twice the keyframe spacing apart (full SLAM; exact: 0)
  closures_bad     accepted closures whose measured translation misses
                   the true relative translation of their two keyframes
                   by more than CLOSURE_FALSE_M: false closures (full
                   SLAM); the largest miss is closure_err_max_m

The final map and landmarks are judged by `world.judge` (`map_off_m`,
`map_voxels_missing`, `landmark_off_max_m`, `posts_missed_share`).  A
cell's file (`workloads/<cell>.json`, `check.limits`) names the numbers
it compares and their limits; the others are printed for the record.
`judge` also returns, for the record, where in the pass the worst drift
and the worst position error fell, and the 99th percentile of the drift.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from slambench.reference import truth

TIME_TOL_US = 250.0
CLOSURE_FALSE_M = 2.0


def frames_bad(ref_us: np.ndarray, prog_us: np.ndarray) -> int:
    """Unmatched frames of either side (both sorted ascending)."""
    i = j = matched = 0
    while i < len(ref_us) and j < len(prog_us):
        d = prog_us[j] - ref_us[i]
        if abs(d) <= TIME_TOL_US:
            matched += 1
            i += 1
            j += 1
        elif d < 0:
            j += 1
        else:
            i += 1
    return int(len(ref_us) + len(prog_us) - 2 * matched)


def drift(pos: np.ndarray, tpos: np.ndarray, lag: int) -> np.ndarray:
    """|(p_{k+lag} - p_k) - (p*_{k+lag} - p*_k)| in x, y, for each k;
    a non-finite position reads as infinitely far."""
    d = (pos[lag:] - pos[:-lag])[:, :2] - (tpos[lag:] - tpos[:-lag])[:, :2]
    e = np.linalg.norm(d, axis=-1)
    return np.where(np.isfinite(e), e, np.inf)


def _yaw_deg_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.rad2deg(np.abs((b - a + np.pi) % (2 * np.pi) - np.pi))


def judge(out: Dict, ref_us: np.ndarray, path, t0_us: int,
          rules: Dict) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(numbers, diagnostics) of one pass (see the module's docstring);
    `rules` holds `drift_lag_s`, and for full SLAM `keyframe_m` and
    `keyframe_deg`."""
    times = np.asarray(out["times_us"], np.float64)
    nums = {"frames_bad": frames_bad(ref_us, times)}
    diag: Dict[str, float] = {}
    pos = np.asarray(out["positions"], np.float64).reshape(-1, 3)
    tpos, _ = truth.poses(path, t0_us, times)
    rel_s = (times - times[0]) * 1e-6 if len(times) else times
    lag = max(1, int(round(rules["drift_lag_s"] / 0.1)))
    if len(pos) > lag:
        e = drift(pos, tpos, lag)
        k = int(np.argmax(e))
        nums["drift_max_m"] = float(e[k])
        diag.update(drift_worst_at_s=float(rel_s[k]),
                    drift_p99_m=float(np.percentile(e, 99)))
    else:
        nums["drift_max_m"] = float("inf")
    err = np.linalg.norm(pos[:, :2] - tpos[:, :2], axis=-1)
    err = np.where(np.isfinite(err), err, np.inf)
    if len(err):
        k = int(np.argmax(err))
        nums["ate_max_m"] = float(err[k])
        diag["ate_worst_at_s"] = float(rel_s[k])
    else:
        nums["ate_max_m"] = float("inf")
    if "keyframe_times_us" not in out:
        return nums, diag
    kt = np.asarray(out["keyframe_times_us"], np.float64)
    kpos, kyaw = truth.poses(path, t0_us, kt)
    matched = (len(kt) + len(times) - frames_bad(kt, times)) // 2
    gap = np.linalg.norm(np.diff(kpos[:, :2], axis=0), axis=-1)
    turn = _yaw_deg_between(kyaw[:-1], kyaw[1:])
    missing = int(np.sum((gap > 2 * rules["keyframe_m"])
                         | (turn > 2 * rules["keyframe_deg"])))
    nums["keyframes_bad"] = (int(len(kt) - matched + missing) if len(kt)
                             else len(times))
    cl: List = out["closures"]
    if cl:
        ci = np.array([c[0] for c in cl])
        cj = np.array([c[1] for c in cl])
        meas_t = np.array([c[2] for c in cl], np.float64)
        true_t = np.einsum("nji,nj->ni", truth.rot_z(kyaw[ci]),
                           kpos[cj] - kpos[ci])
        miss = np.linalg.norm(meas_t - true_t, axis=-1)
        miss = np.where(np.isfinite(miss), miss, np.inf)
        nums["closures_bad"] = int(np.sum(miss > CLOSURE_FALSE_M))
        diag["closure_err_max_m"] = float(np.max(miss))
    else:
        nums["closures_bad"] = 0
    diag["closures"] = len(cl)
    return nums, diag


def worst(per_pass: List[Tuple[Dict, Dict]]) -> Dict[str, float]:
    """Each number over the passes: counts summed, errors at their
    largest; the diagnostics of every pass under "passes"."""
    out: Dict = {}
    for nums, _ in per_pass:
        for k, v in nums.items():
            if k.endswith("_bad"):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, -np.inf), v)
    out["passes"] = [d for _, d in per_pass]
    return out
