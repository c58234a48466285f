"""mme_tpu_torch — the PyTorch/CUDA port of ``mme_tpu``.

The package mirrors ``mme_tpu``'s layout (``ops/attention.py``,
``models/layers.py``, ...) so every module names its JAX counterpart, and it
is held against that counterpart by the ``tests/test_torch_*.py`` tests on
the same weights and inputs. It imports torch and numpy only: nothing of JAX
and nothing of ``mme_tpu``.

The Pallas kernels of ``mme_tpu`` become kernels written by hand for Hopper
under ``csrc/``; see ``ops/kernels.py`` for how they are built and loaded.
"""
