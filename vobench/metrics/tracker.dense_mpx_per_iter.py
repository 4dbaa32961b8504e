"""Millions of pixels a dense LM iteration evaluates, averaged over the
levels as the loop visits them: ``tracking/tracker.DENSE_PX`` /
``DENSE_ITERS`` / 1e6 (program counters: the pixels of every dense system
evaluated, B * H_l * W_l an iteration, and the dense iterations run), over
every step the run's process made before the read: the warm-up's and the
window's. Nothing where the program has no such counters or ran no dense
iteration."""


def read(run):
    from odometry_torch.tracking import tracker

    iters = getattr(tracker, "DENSE_ITERS", 0)
    if not iters or not hasattr(tracker, "DENSE_PX"):
        return None
    return tracker.DENSE_PX / iters / 1e6
