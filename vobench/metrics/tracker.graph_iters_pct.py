"""The share of the tracker's LM iterations replayed from a CUDA graph:
100 * ``tracking/tracker.GRAPH_ITERS`` / ``LM_ITERS`` (program counters:
every iteration the host loop ran, and those of them replayed), over every
step the run's process made before the read: the warm-up's and the
window's. Nothing where the program has no such counters or ran no
iteration."""


def read(run):
    from odometry_torch.tracking import tracker

    iters = getattr(tracker, "LM_ITERS", 0)
    if not iters or not hasattr(tracker, "GRAPH_ITERS"):
        return None
    return 100.0 * tracker.GRAPH_ITERS / iters
