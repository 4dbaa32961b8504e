"""Sequences per depth-frontend run of the program's steps: the change of
``pipeline.odometry.DEPTH_LANES`` over that of ``DEPTH_RUNS`` (program
counters: one run per batched depth run or lazy sub-batch, its sequences;
inits not counted), over every step the run's process made before the read:
the warm-up's and the window's. Nothing where the program has no such
counters or its steps ran no depth."""


def read(run):
    from odometry_torch.pipeline import odometry

    runs = getattr(odometry, "DEPTH_RUNS", 0)
    return odometry.DEPTH_LANES / runs if runs else None
