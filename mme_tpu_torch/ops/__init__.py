"""Ops of the port: attention (with the flash kernel), LayerNorm, audio and
video mask math. Each module names its ``mme_tpu/ops`` counterpart."""
