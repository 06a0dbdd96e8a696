"""Camera traffic: one general generator of closed pose loops.

A traffic mix is a data file of parameters; the generator turns it, a
configuration's viewpoint and a seed into a loop of ``loop_poses`` camera
poses that a run cycles through (one frame a pose, one frame in flight), so
a faster renderer covers more loops of the same mix.

Pose k of the loop, t = k / loop_poses:

- the eye orbits the viewpoint's ``target`` at its ``distance`` and
  ``height``, at azimuth a0 + ``sweep_deg`` * t, a0 drawn from the seed
  when ``sweep_deg`` is 360 (a full orbit) and the viewpoint's own azimuth
  otherwise;
- the head sways around that pose: yaw and pitch of the view direction and
  a translation of the eye, each a sum of three sinusoids of 1 to 3 cycles
  a loop with seeded phases and weights, scaled so that the largest swing
  is ``yaw_deg``, ``pitch_deg`` and ``shift_m``;
- each pose's eye moves by a seeded uniform ``jitter_m`` on every axis.

Cameras are OpenCV-convention pinhole cameras (Metal NDC, z in [0, 1]) with
the viewpoint's vertical field of view, near and far planes.
"""

from __future__ import annotations

import math

import numpy as np


def projection(width: int, height: int, near: float, far: float,
               fov_deg: float) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = f * height / width
    p[1, 1] = f
    p[2, 2] = far / (far - near)
    p[2, 3] = -(far * near) / (far - near)
    p[3, 2] = 1.0
    return p


def look_along(eye, forward, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """View matrix of a camera at ``eye`` looking along ``forward``."""
    z = np.asarray(forward, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = x, y, z
    view[:3, 3] = -view[:3, :3] @ np.asarray(eye, np.float64)
    return view.astype(np.float32)


def _sway(rng, loop: int, amplitude: float) -> np.ndarray:
    """A smooth closed curve of ``loop`` samples whose largest swing from 0
    is ``amplitude``."""
    if amplitude == 0.0:
        return np.zeros(loop)
    t = np.arange(loop) / loop
    weights = rng.uniform(0.5, 1.0, 3)
    phases = rng.uniform(0.0, 2.0 * math.pi, 3)
    curve = sum(w * np.sin(2.0 * math.pi * (c + 1) * t + p)
                for c, (w, p) in enumerate(zip(weights, phases)))
    return amplitude * curve / np.abs(curve).max()


def poses(traffic: dict, viewpoint: dict, seed: int) -> list:
    """The loop of poses: a list of (eye (3,), forward (3,)) float64."""
    rng = np.random.default_rng(int(seed))
    loop = int(traffic["loop_poses"])
    sweep = math.radians(traffic["sweep_deg"])
    a0 = (rng.uniform(0.0, 2.0 * math.pi) if traffic["sweep_deg"] == 360
          else math.radians(viewpoint.get("azimuth_deg", 0.0)))
    yaw = np.radians(_sway(rng, loop, traffic["yaw_deg"]))
    pitch = np.radians(_sway(rng, loop, traffic["pitch_deg"]))
    shift = np.stack([_sway(rng, loop, traffic["shift_m"]) for _ in range(3)], -1)
    jitter = rng.uniform(-1.0, 1.0, (loop, 3)) * traffic["jitter_m"]
    target = np.asarray(viewpoint["target"], np.float64)
    out = []
    for k in range(loop):
        a = a0 + sweep * k / loop
        eye = target + np.array([viewpoint["distance"] * math.sin(a),
                                 viewpoint["height"],
                                 -viewpoint["distance"] * math.cos(a)])
        fwd = target - eye
        # yaw about the world's vertical, then pitch up or down
        heading = math.atan2(fwd[0], fwd[2]) + yaw[k]
        level = math.atan2(fwd[1], math.hypot(fwd[0], fwd[2])) + pitch[k]
        fwd = np.array([math.cos(level) * math.sin(heading), math.sin(level),
                        math.cos(level) * math.cos(heading)])
        out.append((eye + shift[k] + jitter[k], fwd))
    return out


def camera(pose, cam: dict, width: int, height: int) -> dict:
    """The camera of a pose: ``view``, ``proj``, ``position``, ``near``,
    ``far`` (host arrays and floats)."""
    eye, fwd = pose
    return dict(view=look_along(eye, fwd),
                proj=projection(width, height, cam["near"], cam["far"],
                                cam["fov_deg"]),
                position=np.asarray(eye, np.float32), near=float(cam["near"]),
                far=float(cam["far"]))


def stereo_rig(mono: dict, ipd: float) -> list:
    """Left and right eyes of a side-by-side rig: the mono camera shifted
    by -+ipd/2 along its own x axis."""
    eyes = []
    view = mono["view"]
    right_axis = view[0, :3].astype(np.float64)
    for sign in (-1.0, 1.0):
        shift = np.eye(4, dtype=np.float32)
        shift[0, 3] = -sign * ipd / 2.0
        eyes.append(dict(mono, view=(shift @ view).astype(np.float32),
                         position=(mono["position"] + sign * right_axis
                                   * (ipd / 2.0)).astype(np.float32)))
    return eyes
