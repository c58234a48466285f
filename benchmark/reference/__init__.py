"""Plain float32 PyTorch reference of the benchmark's models.

It imports nothing of the measured program and takes nothing the program
made: the benchmark hands it the same weights and inputs it hands the
program, and it recomputes everything derived from them (normalised
video, keep-masks, feature masks, positions).
"""

import contextlib

import torch


@contextlib.contextmanager
def fp32_math(tf32: bool = False):
    """TF32 off for matmuls and cuDNN inside (``tf32=True``: on, the
    control of a float32 configuration)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
