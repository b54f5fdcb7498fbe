"""PyTorch / CUDA port of the visual SLAM engine, for NVIDIA Hopper (H100).

The JAX package `orb_slam2_detailed_comments_tpu` is the reference; every
module here sits at the same relative path as its counterpart there and
computes the same thing with plain PyTorch tensors on an explicit device.
The Pallas kernels of the per-frame tracking program are hand-written
CUDA C++ kernels (`csrc/`), built by `ops/_kernels.py` at first use:

  ops/fast_pyramid.py  + csrc/fast_pyramid.cu  FAST/NMS/raw/blur maps, and
                                               the NMS-only map (K5, with an
                                               exact early rejection)
  ops/orb_desc.py      + csrc/orb_desc.cu      IC angle + rotated BRIEF
                                               (the ORB window gather fused
                                               with its consumer)
  ops/stereo_sad.py    + csrc/stereo_sad.cu    the stereo SAD refinement
                                               (the SAD window gather fused
                                               with its consumer)
  ops/patch_gather.py  + csrc/patch_gather.cu  clamped window gather (on no
                                               path: both its call sites are
                                               fused)

Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version for a CPU tensor.

Ported so far: system.py's System with loop closing off (the tracker,
local mapping, relocalization) and everything it runs; its modules beyond
the tracking program are plain PyTorch.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and pose solves need true f32 matmuls: no TF32 anywhere, the
# counterpart of the JAX package's "jax_default_matmul_precision=float32".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
