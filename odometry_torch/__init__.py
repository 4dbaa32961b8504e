"""odometry_torch — the PyTorch / CUDA port of ``odometry_tpu``.

The JAX package ``odometry_tpu`` is the reference; this package keeps its
module paths and function names so every function has an obvious
counterpart (``odometry_torch/tracking/tracker.py`` <->
``odometry_tpu/tracking/tracker.py``). Plain tensor code is PyTorch; the one
Pallas kernel on the fast_config path (the banded SSD search) is a CUDA C++
kernel for sm_90a (``csrc/disparity_band.cu``), built at first use.

Precision: the reference contracts every matmul at ``Precision.HIGHEST``
(``kernels/points.py:25``, ``kernels/disparity.py:31``,
``image/pyramid.py:33``), so TF32 is switched off for matmuls and cuDNN
convolutions (cuDNN defaults to TF32 on the card).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
