"""Image classifier entry point: ``-m ResNet`` → ResNet-50 with a fresh
``fc`` over a frozen backbone; any other name → the scratch ConvNet.

Port of ``mme_tpu/cli/images_nn.py``. The Hateful-Memes binary task by
default: ``-y 7`` (the flag's default) on a dataset whose name holds
"hateful" becomes 2 classes. The ConvNet's binary sigmoid head (one output
for 2 classes) serves as the two-class ``[1 - p, p]``. Data is synthetic:
32×32 images and 64 training records for ``--dataset synthetic``, else
224×224 and 6 750. The frozen backbone is the optimizer's trainable mask:
every parameter whose path holds a module named ``fc`` trains (the head's
and the backbone's own unused ``fc``, as in JAX), so the backbone's
BatchNorm statistics still follow the data. Runs on the card::

    python -m mme_tpu_torch.cli.images_nn --dataset synthetic -m ResNet -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from torch import nn

from mme_tpu_torch.cli.common import BatchModel, run_classifier
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.synthetic import synthetic_image_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.image import ConvNetClassifier, ResnetClassifier


def fc_trainable_mask(model: nn.Module) -> List[bool]:
    """One bool per parameter: True where the parameter's path holds a
    module named ``fc`` (JAX marks the flax leaves whose path has a key
    ``fc``)."""
    return ["fc" in name.split(".")[:-1]
            for name, _ in model.named_parameters()]


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("images_nn", argv)
    cfg = config_from_args(args, device=device)
    if cfg.output_dim == 7 and "hateful" in cfg.dataset.lower():
        cfg = cfg.replace(output_dim=2)
    np.random.seed(cfg.seed)

    synthetic = cfg.dataset == "synthetic"
    size = 32 if synthetic else 224
    if cfg.model.lower() == "resnet":
        net = ResnetClassifier(cfg.output_dim, device=dev)
    else:
        # a binary task takes the one-output sigmoid head ([B]); more
        # classes take per-class sigmoid scores
        net = ConvNetClassifier(
            tuple(cfg.hidden_layer_dims),
            1 if cfg.output_dim == 2 else cfg.output_dim, size, device=dev)
    net.load_state_dict(from_flax(**init_variables(net, cfg.seed)),
                        strict=True)
    model = BatchModel(net, ("image",))
    trainable = (fc_trainable_mask(model)
                 if isinstance(net, ResnetClassifier) else None)

    n_train = 64 if synthetic else 6750
    mk = lambda n, s: synthetic_image_dataset(
        n, size=size, num_classes=cfg.output_dim, seed=s)
    train_ds, val_ds, test_ds = mk(n_train, 0), mk(16, 1), mk(16, 2)
    return run_classifier(cfg, model, train_ds, val_ds, test_ds,
                          trainable_mask=trainable, device=dev)


if __name__ == "__main__":
    main()
