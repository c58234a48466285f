"""Record constants of ``mme_tpu/data/records.py`` that the port needs.

The port keeps its own copy so it never imports ``mme_tpu``.
"""

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
