"""The share of the dense tracking engine's pixel work that carried weight:
100 * ``tracking/tracker.dense_weighted()`` / ``DENSE_PX`` (program
counters: the pixels of every dense system evaluated, B * H_l * W_l an LM
iteration, and those of them with a residual, summed on the card inside
the iteration), over every step the run's process made before the read: the
warm-up's and the window's. Nothing where the program has no such counters
or ran no dense iteration."""


def read(run):
    from odometry_torch.tracking import tracker

    px = getattr(tracker, "DENSE_PX", 0)
    if not px or not hasattr(tracker, "dense_weighted"):
        return None
    return 100.0 * tracker.dense_weighted() / px
