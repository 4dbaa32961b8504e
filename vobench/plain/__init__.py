"""The plain reference of the benchmark: the odometry step in plain PyTorch.

A frozen copy of the port's step (``odometry_torch`` at the commit that added
the benchmark: config, camera, geometry, pyramids, sampling, point lists,
selection, photometric terms, solvers, depth frontend, tracker and pipeline),
which the repository's CPU tests hold to the JAX package. Two departures:
the SSD winner maps are searched in plain PyTorch in the SSD kernels' order
of operations (``disparity.py``), never by a kernel, and every image-sized
tensor passes :func:`vobench.plain.precision.q`, which the control uses to
compute in bfloat16. It imports nothing of ``odometry_torch``, so a later
change to the program is held to these semantics.
"""
