"""The SSD search kernels' (B1 ``band_kernel``, B2 ``full_kernel``) share of
their roofline over the traced steps: the sum over launches of the least
time the card could take for the launch's images (``stats.search_work`` per
image, times the images of the launch: the grid's second dimension, or every
lane where the configuration runs depth on every lane of every frame) over
the launches' kernel time in the trace, in percent. Nothing when no launch
was traced or a launch's images are unknown."""

from vobench.stats import bound_s, search_work


def read(run):
    t = run.trace
    if t is None or not t.ssd_launches:
        return None
    from vobench.plain.config import CameraConfig, DepthConfig
    from vobench.plain.estimator import search_band

    p = run.cell.config["pipeline"]
    cam = CameraConfig(**p["camera"])
    depth = DepthConfig(**p["depth"])
    min_d, max_d = search_band(cam, depth)
    one = bound_s(*search_work(cam.height, cam.width, depth.boundary, min_d, max_d,
                               depth.lr_check))
    bound = busy = 0.0
    for _, seconds, grid in t.ssd_launches:
        if grid is not None:
            images = grid[1]
        elif p["depth_every_frame"]:
            images = run.lanes
        else:
            return None
        bound += images * one
        busy += seconds
    return 100.0 * bound / busy
