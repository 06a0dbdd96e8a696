"""Entry ``render``: one mono frame, ``renderer.render(gi, camera, W, H)``,
and the reference's mono frame at the same pose.  Also the cameras of a
pose that the other entries share."""

from gsmbench.harness import traffic


def port_camera(T, c):
    """The renderer's CameraParams of a camera dict."""
    return T.CameraParams(view_matrix=c["view"], projection_matrix=c["proj"],
                          position=c["position"],
                          focal_x=float(c["proj"][0, 0]) * c["width"] / 2.0,
                          focal_y=float(c["proj"][1, 1]) * c["height"] / 2.0,
                          near_plane=c["near"], far_plane=c["far"])


def camera(config, pose):
    """The configuration's camera at a pose."""
    w, h = config["width"], config["height"]
    return dict(traffic.camera(pose, config["camera"], w, h), width=w, height=h)


def rig(config, pose):
    """The side-by-side eyes around a pose, left first."""
    return traffic.stereo_rig(camera(config, pose), config["ipd"])


def build(T, config, renderer, gi):
    """The frame function of a pose: a new CameraParams, then the call."""
    w, h = config["width"], config["height"]

    def frame(pose):
        return renderer.render(gi, port_camera(T, camera(config, pose)), w, h)

    return frame


def reference(ref, config, pose):
    return ref.mono(camera(config, pose), config["width"], config["height"])
