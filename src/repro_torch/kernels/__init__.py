"""Hand-written Hopper kernels and their plain PyTorch versions.

fp32 means fp32 in the port, as in the JAX reference: TF32 is turned off
for matrix products and cuDNN here, where the kernels package loads.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
