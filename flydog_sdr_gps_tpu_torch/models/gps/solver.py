"""Position solutions: single-point least squares + EKF.

Reference: `gps/PosSolver.cpp` (195) orchestrating
`SinglePointPositionSolver.h` (iterative LS with earth-rotation
correction) and `EKFPositionSolver.h` (Kalman with clock bias/drift
states), fed by pseudoranges built from 48-bit tick counts + code
phase (`gps/solve.cpp:60-167`).  Host numpy, 0.5 Hz duty — exactly the
reference's cadence (`gps/solve.cpp:567-646`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ephemeris import OMEGA_E

C_LIGHT = 2.99792458e8


def lla_from_ecef(p: np.ndarray) -> tuple[float, float, float]:
    """WGS-84 ECEF -> (lat deg, lon deg, alt m) — closed-form Bowring."""
    a, f = 6378137.0, 1 / 298.257223563
    b = a * (1 - f)
    e2 = f * (2 - f)
    x, y, z = p
    lon = np.arctan2(y, x)
    r = np.hypot(x, y)
    ep2 = (a * a - b * b) / (b * b)
    th = np.arctan2(a * z, b * r)
    lat = np.arctan2(z + ep2 * b * np.sin(th) ** 3,
                     r - e2 * a * np.cos(th) ** 3)
    n = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    alt = r / np.cos(lat) - n
    return float(np.degrees(lat)), float(np.degrees(lon)), float(alt)


def az_el(rx_ecef: np.ndarray, sat_ecef: np.ndarray
          ) -> tuple[float, float]:
    """Azimuth/elevation (deg) of a satellite from a receiver position
    (the sky-map view, `gps/stat.cpp` az/el plots)."""
    lat, lon, _ = lla_from_ecef(np.asarray(rx_ecef, float))
    lat, lon = np.radians(lat), np.radians(lon)
    d = np.asarray(sat_ecef, float) - np.asarray(rx_ecef, float)
    # ECEF -> ENU
    e = -np.sin(lon) * d[0] + np.cos(lon) * d[1]
    n = (-np.sin(lat) * np.cos(lon) * d[0]
         - np.sin(lat) * np.sin(lon) * d[1] + np.cos(lat) * d[2])
    u = (np.cos(lat) * np.cos(lon) * d[0]
         + np.cos(lat) * np.sin(lon) * d[1] + np.sin(lat) * d[2])
    az = float(np.degrees(np.arctan2(e, n))) % 360.0
    el = float(np.degrees(np.arctan2(u, np.hypot(e, n))))
    return az, el


def solve_ls(sat_pos: np.ndarray, pranges: np.ndarray,
             x0: np.ndarray | None = None, iters: int = 8
             ) -> tuple[np.ndarray, float, float]:
    """Iterative single-point LS.

    sat_pos: (n, 3) ECEF satellite positions at transmit time.
    pranges: (n,) pseudoranges (m), SV clock already removed.
    Returns (pos ECEF (3,), receiver clock bias (m), residual RMS).
    Includes the Sagnac (earth-rotation) correction the reference
    applies (`SinglePointPositionSolver.h` RotSatCoordinates).
    """
    n = len(pranges)
    if n < 4:
        raise ValueError("need >= 4 satellites")
    x = np.zeros(4) if x0 is None else np.append(x0, 0.0)
    for _ in range(iters):
        # rotate sat positions by earth rotation during flight time
        tof = (pranges - x[3]) / C_LIGHT
        ang = OMEGA_E * tof
        ca, sa = np.cos(ang), np.sin(ang)
        sx = ca * sat_pos[:, 0] + sa * sat_pos[:, 1]
        sy = -sa * sat_pos[:, 0] + ca * sat_pos[:, 1]
        sp = np.stack([sx, sy, sat_pos[:, 2]], axis=1)
        d = sp - x[:3]
        rho = np.linalg.norm(d, axis=1)
        resid = pranges - (rho + x[3])
        h = np.concatenate([-d / rho[:, None], np.ones((n, 1))], axis=1)
        dx, *_ = np.linalg.lstsq(h, resid, rcond=None)
        x += dx
        if np.linalg.norm(dx[:3]) < 1e-4:
            break
    rms = float(np.sqrt(np.mean(resid ** 2)))
    return x[:3].copy(), float(x[3]), rms


@dataclasses.dataclass
class EkfSolver:
    """8-state EKF: position (3), velocity (3), clock bias, drift.

    Reference: `gps/EKFPositionSolver.h` (adapted constants).  Units m,
    m/s; bias/drift in meters / meters-per-second of light time.
    """
    q_pos: float = 0.1          # process noise accel (m/s^2)^2
    q_clk: float = 10.0         # clock drift noise
    r_prange: float = 100.0     # pseudorange variance (m^2)
    x: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(8))
    p: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([1e8] * 3 + [100.0] * 3
                                        + [1e10, 1e4]))
    initialized: bool = False

    def update(self, sat_pos: np.ndarray, pranges: np.ndarray,
               dt: float) -> np.ndarray:
        if not self.initialized:
            pos, bias, _ = solve_ls(sat_pos, pranges)
            self.x[:3] = pos
            self.x[6] = bias
            self.initialized = True
        # predict
        f = np.eye(8)
        f[0, 3] = f[1, 4] = f[2, 5] = dt
        f[6, 7] = dt
        q = np.zeros((8, 8))
        q[3, 3] = q[4, 4] = q[5, 5] = self.q_pos * dt
        q[7, 7] = self.q_clk * dt
        q[0, 0] = q[1, 1] = q[2, 2] = 0.25 * self.q_pos * dt ** 3
        self.x = f @ self.x
        self.p = f @ self.p @ f.T + q
        # measurement (with the same earth-rotation correction as LS)
        n = len(pranges)
        tof = (pranges - self.x[6]) / C_LIGHT
        ang = OMEGA_E * tof
        ca, sa = np.cos(ang), np.sin(ang)
        sat_pos = np.stack([ca * sat_pos[:, 0] + sa * sat_pos[:, 1],
                            -sa * sat_pos[:, 0] + ca * sat_pos[:, 1],
                            sat_pos[:, 2]], axis=1)
        d = sat_pos - self.x[:3]
        rho = np.linalg.norm(d, axis=1)
        pred = rho + self.x[6]
        h = np.zeros((n, 8))
        h[:, :3] = -d / rho[:, None]
        h[:, 6] = 1.0
        r = np.eye(n) * self.r_prange
        s = h @ self.p @ h.T + r
        k = self.p @ h.T @ np.linalg.inv(s)
        self.x = self.x + k @ (pranges - pred)
        self.p = (np.eye(8) - k @ h) @ self.p
        return self.x[:3].copy()


def pseudoranges_from_tracking(code_phases_chips: np.ndarray,
                               epoch_counts: np.ndarray,
                               ms_per_epoch: float = 1.0,
                               chip_rate: float = 1.023e6
                               ) -> np.ndarray:
    """Relative pseudoranges from tracking state.

    The reference builds transmit times from the 48-bit tick counter +
    code phase + bit/subframe counts (`gps/solve.cpp:60-167`).  Here:
    transmit-time offset (s) = epochs * 1 ms + code_phase / chip_rate;
    pseudorange differences are what the solver needs (common receiver
    clock bias absorbs the absolute offset).
    """
    t_tx = (np.asarray(epoch_counts) * ms_per_epoch * 1e-3
            + np.asarray(code_phases_chips) / chip_rate)
    return -t_tx * C_LIGHT
