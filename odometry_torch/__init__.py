"""odometry_torch — the PyTorch / CUDA port of ``odometry_tpu``.

The JAX package ``odometry_tpu`` is the reference; this package keeps its
module paths and function names so every function has an obvious
counterpart (``odometry_torch/tracking/tracker.py`` <->
``odometry_tpu/tracking/tracker.py``). Plain tensor code is PyTorch; the
reference's Pallas kernels are CUDA C++ kernels for sm_90a, built at first
use: the banded SSD search (``csrc/disparity_band.cu``, fast_config), the
full-search SSD (``csrc/disparity_full.cu``, kitti_config and
accurate_config) and the ring all-gather of keyframe blocks
(``csrc/ring_gather.cu``). The package imports nothing of ``odometry_tpu``.

Precision: the reference contracts every matmul at ``Precision.HIGHEST``
(``kernels/points.py:25``, ``kernels/disparity.py:31``,
``image/pyramid.py:33``, ``mapping/ba.py:48``), so TF32 is switched off for
matmuls, which ``torch.einsum`` and ``bmm`` run on, and for cuDNN
convolutions (cuDNN defaults to TF32 on the card).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
