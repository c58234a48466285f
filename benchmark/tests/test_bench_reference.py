"""The plain references agree with the port at a small size on seeded
weights (forward, loss, every gradient), and neither the harness nor the
reference loads JAX or the JAX package (nor, for the reference, the
port)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import BENCH, tiny


def _port_and_reference(name: str):
    from harness import weights
    from harness.common import model
    c = tiny(name)
    c["compute_dtype"] = "float32"
    w, _ = weights.draw(c, 7, "cpu")
    ref = model(c).reference(c, device="cpu")
    ref.load_state_dict(w, strict=True)
    return c, model(c).port(c, "cpu", w), ref


def _batch(c):
    from harness import data
    feats, labels = data.make_pool(c, {"pool": 4, "text_len": {"min": 3,
                                                               "max": 16},
                                       "speech_s": {"median": 2.8,
                                                    "sigma": 0.55,
                                                    "min": 0.75,
                                                    "max": 6.0}}, 3)
    return ({k: torch.from_numpy(v.copy()) for k, v in feats.items()},
            torch.from_numpy(labels))


@pytest.mark.parametrize("name", ["tav", "text_video"])
def test_reference_matches_port(name):
    c, port, ref = _port_and_reference(name)
    batch, labels = _batch(c)
    from harness.common import model
    transform = model(c).transform(c)
    pbatch = dict(batch) if transform is None else transform(None,
                                                             dict(batch))
    port.train()
    ref.train()
    lp = port(pbatch)
    lr = ref(batch)
    np.testing.assert_allclose(lp.detach(), lr.detach(), rtol=1e-4,
                               atol=1e-5)
    loss_p = F.cross_entropy(lp, labels)
    loss_r = F.cross_entropy(lr, labels)
    assert float(loss_p) == pytest.approx(float(loss_r), rel=1e-5)
    gp = dict(zip([n.removeprefix("net.") for n, _ in
                   port.named_parameters()],
                  torch.autograd.grad(loss_p, list(port.parameters()),
                                      allow_unused=True)))
    gr = dict(zip([n for n, _ in ref.named_parameters()],
                  torch.autograd.grad(loss_r, list(ref.parameters()),
                                      allow_unused=True)))
    assert set(gp) == set(gr)
    for n in gr:
        a = torch.zeros(()) if gp[n] is None else gp[n]
        b = torch.zeros(()) if gr[n] is None else gr[n]
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-3 * scale, n


def _guarded(code: str, blocked) -> subprocess.CompletedProcess:
    guard = (
        "import sys\n"
        f"BLOCKED = {tuple(blocked)!r}\n"
        "class Guard:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Guard())\n"
        f"sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}]\n")
    return subprocess.run([sys.executable, "-c", guard + code],
                          capture_output=True, text=True, timeout=600)


CHECK = ("names = {{m.split('.')[0] for m in sys.modules}}\n"
         "bad = sorted(names & set({blocked!r}))\n"
         "assert not bad, bad\n"
         "print('clean')\n")


def test_harness_loads_no_jax():
    blocked = ("jax", "jaxlib", "flax", "optax", "mme_tpu")
    code = ("import run, control, flops\n"
            "from harness import program, trace\n"
            "from harness.common import cell, model, plugin\n"
            "for w in ('tav.train.b8', 'text_video.train.b8', "
            "'tav.serve.b32'):\n"
            "    c = cell(w)\n"
            "    plugin('loops', c['traffic']['loop'])\n"
            "    model(c['config'])\n"
            "from mme_tpu_torch.train.build_tav import build_tav\n"
            "from mme_tpu_torch.cli.text_video_nn import INPUTS\n"
            "from mme_tpu_torch.serve import Predictor\n"
            "from mme_tpu_torch.data.prefetch import prefetch_batches\n"
            + CHECK.format(blocked=blocked))
    p = _guarded(code, blocked)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-3000:]


def test_reference_loads_nothing_of_the_program():
    blocked = ("jax", "jaxlib", "flax", "optax", "mme_tpu", "mme_tpu_torch")
    code = ("import reference, flops\n"
            "from reference import layers, optim, towers\n"
            "from harness import check, data, weights\n"
            "from harness.common import load, model\n"
            "for name in ('tav', 'text_video'):\n"
            "    c = load('configs', name)\n"
            "    model(c).reference(c, device='meta')\n"
            "    flops.forward_flops(c, 8)\n"
            + CHECK.format(blocked=blocked))
    p = _guarded(code, blocked)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-3000:]
