"""PyTorch / CUDA port of ``quad_periodic_mpc_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package.  Entry points run on ``cuda`` unless
the caller passes CPU tensors (or ``device="cpu"``); on the CPU every
hand-written kernel is replaced by its plain PyTorch version.  Nothing
here imports JAX or the JAX package.
"""

import torch

# Everything is float32, and float32 products must stay full float32:
# TF32 keeps ~3 decimal digits, the class of reduced-precision error the
# reference found in its model build (docs/KERNELS.md design rule 3).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
