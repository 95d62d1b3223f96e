"""PyTorch + CUDA port of the EM-Fusion engine (``emfusion_tpu``).

The JAX package beside it stays the reference; this package imports
nothing of it, nor JAX. Entry points run on the GPU (``device=None``
means ``cuda``) and raise when there is none; the tests pass
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version. The SE(3) and LM math needs full float32 products, so TF32 is
switched off here for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
