"""PyTorch/CUDA port of the split-serving system (``repro`` is the JAX
reference; this package mirrors its layout module for module).

Precision is set here, once: fp32 matrix products and fp32 cuDNN
convolutions both run in full fp32 (TF32 off), so a comparison against
the reference sees summation-order noise only, not TF32's ~1e-3.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
