"""Entry ``render_stereo_foveated``: one foveated stereo frame,
``renderer.render_stereo_foveated(gi, rig, target)``, the rig a side-by-side
pair of eyes around the pose and the target the configuration's rate maps;
and the reference's foveated frame of the same rig, its target worked out
again from the same rate-map parameters."""

from gsmbench.entries.render import port_camera, rig
from gsmbench.reference import foveation


def build(T, config, renderer, gi):
    fov = config["foveation"]
    target = T.make_rate_maps(config["width"], config["height"],
                              min_rate=fov["min_rate"], radius=fov["radius"])

    def frame(pose):
        left, right = (port_camera(T, c) for c in rig(config, pose))
        return renderer.render_stereo_foveated(
            gi, T.StereoCameraParams(left=left, right=right), target)

    return frame


def reference(ref, config, pose):
    fov = config["foveation"]
    tgt = foveation.target(config["width"], config["height"], fov["min_rate"],
                           fov["radius"], ref.tile, ref.tile)
    return ref.stereo(rig(config, pose), config["width"], config["height"],
                      fov=tgt)
