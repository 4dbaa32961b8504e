"""Command-line tools of the port (counterparts of the reference's
``tools/``): ``accuracy_sweep``, ``kernel_parity`` and ``profile_step``,
each run with ``python -m odometry_torch.tools.<name>``."""
