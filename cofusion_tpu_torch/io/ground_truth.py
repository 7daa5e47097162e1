"""Ground-truth poses for the '-p' flag — the port's copy of
cofusion_tpu/io/ground_truth.py (the reference's
GUI/Tools/GroundTruthOdometry.{h,cpp}).

The file is TUM-style `ts x y z qx qy qz qw`, comma- or space-separated
(GroundTruthOdometry.cpp:25-48), read by the port's
`utils/export.load_tum_trajectory`.  Per-frame deltas are chained as the
reference computes them (T_last^-1 T_now, GroundTruthOdometry.cpp:50-62)
and accumulated, as the JAX package does: the Co-Fusion fork passes the raw
delta to overridePose (CoFusion.cpp:342), which would replay only the last
increment.  `isam_basis=True` applies the reference's iSAM basis change
M^-1 delta M (GroundTruthOdometry.cpp:56-62); off for camera-convention
files such as the '-ep' exports.
"""

from __future__ import annotations

import numpy as np

from cofusion_tpu_torch.utils.export import load_tum_trajectory

_M_ISAM = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64
)


class GroundTruthOdometry:
    def __init__(self, path: str, isam_basis: bool = False):
        ts, poses = load_tum_trajectory(path)
        if len(ts) == 0:
            raise IOError(f"no poses in {path}")
        self._by_ts = {int(t): poses[i] for i, t in enumerate(ts)}
        self._ts_sorted = np.asarray(sorted(self._by_ts), np.int64)
        self.isam_basis = isam_basis
        self._last_ts: int | None = None
        self._pose = np.eye(4, dtype=np.float64)

    def _lookup(self, timestamp: int) -> np.ndarray | None:
        """The pose at `timestamp`, or at the nearest logged one within half
        the median spacing (the reference needs exact matches and skips the
        frame otherwise); None when there is none."""
        if int(timestamp) in self._by_ts:
            return self._by_ts[int(timestamp)]
        i = int(np.searchsorted(self._ts_sorted, timestamp))
        best, bd = None, None
        for j in (i - 1, i):
            if 0 <= j < len(self._ts_sorted):
                d = abs(int(self._ts_sorted[j]) - int(timestamp))
                if bd is None or d < bd:
                    best, bd = int(self._ts_sorted[j]), d
        if best is not None and len(self._ts_sorted) > 1:
            if bd <= 0.5 * float(np.median(np.diff(self._ts_sorted))):
                return self._by_ts[best]
        return None

    def pose_for(self, timestamp: int) -> np.ndarray:
        """Accumulated camera pose, identity at the first queried frame; an
        unknown timestamp holds the last pose."""
        T = self._lookup(timestamp)
        if T is None:
            return self._pose.copy()
        if self._last_ts is not None:
            T_last = self._lookup(self._last_ts)
            if T_last is not None:
                delta = np.linalg.inv(T_last) @ T
                if self.isam_basis:
                    delta = np.linalg.inv(_M_ISAM) @ delta @ _M_ISAM
                self._pose = self._pose @ delta
        self._last_ts = int(timestamp)
        return self._pose.copy()
