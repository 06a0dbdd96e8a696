"""Entry ``render_stereo``: one side-by-side stereo frame,
``renderer.render_stereo(gi, rig, W, H)`` into an (H, 2W) image, the rig a
side-by-side pair of eyes around the pose; and the reference's
side-by-side frame of the same rig (``reference/side_by_side.py``)."""

from gsmbench.entries.render import port_camera, rig
from gsmbench.reference import side_by_side


def build(T, config, renderer, gi):
    """The frame function of a pose: a new StereoCameraParams, then the
    call."""
    w, h = config["width"], config["height"]

    def frame(pose):
        left, right = (port_camera(T, c) for c in rig(config, pose))
        return renderer.render_stereo(
            gi, T.StereoCameraParams(left=left, right=right), w, h)

    return frame


def reference(ref, config, pose):
    return side_by_side.stereo(ref, rig(config, pose), config["width"],
                               config["height"])
