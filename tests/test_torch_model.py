"""The port's models (mme_tpu_torch/models) against mme_tpu/models on one
tiny-spec flax parameter tree and the same numpy-seeded batch: the
converter round trip, fp32 parity per tower, the TAVModel logits in fp32
and a bf16 agreement leg.

The flax tree is initialised once per file (module fixture); each tower is
applied as a sub-module of that one tree, in eval mode (the deterministic
forward; tests/test_torch_train.py covers training mode). The batch carries ragged rows
and a fully padded row (text and audio masks all 0), as serving does.

Tolerances: fp32 hidden states agree to 1e-5 at unit scale and the logits
to 1e-4 (fp32 sums in other orders through every layer); bf16 runs round
at other places in the two frameworks, so the port's bf16 logits are held
to JAX's bf16 logits, and both to the fp32 logits, within 5e-2 (both sit
about 1e-2 from fp32 on this batch).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.models import audio as j_audio
from mme_tpu.models import fusion as j_fusion
from mme_tpu.models import text as j_text
from mme_tpu.models import video as j_video

from mme_tpu_torch.convert import from_flax, init_params, to_flax
from mme_tpu_torch.models.audio import Wav2Vec2Model
from mme_tpu_torch.models.fusion import PreFormer, TAVModel, TAVSpec
from mme_tpu_torch.models.text import TextEncoder
from mme_tpu_torch.models.video import VideoMAEModel
from mme_tpu_torch.train.build_tav import example_tav_batch

torch.set_num_threads(2)

SPEC = TAVSpec().tiny()
J_SPEC = j_fusion.TAVSpec().tiny()


def _batch():
    b = example_tav_batch(SPEC, 3, 12, 4000, seed=1)
    b["text_mask"][1, 7:] = 0
    b["audio_mask"][1, 2500:] = 0
    b["text_mask"][2] = 0            # a zero-padded serving row
    b["audio_mask"][2] = 0
    b["video"][2] = 0
    b["video_keep"][2] = False
    return b


@pytest.fixture(scope="module")
def ref():
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # numpy draws at flax's scales (convert.init_params): jit-compiling
    # JAX's init would cost every pytest worker that takes a test of this
    # file ~10 s; test_init_params_matches_flax_tree_and_scales holds the
    # drawn tree against JAX's
    return batch, jb, init_params(SPEC, 0)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _sub(state, prefix):
    return {k[len(prefix) + 1:]: v for k, v in state.items()
            if k.startswith(prefix + ".")}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_converter_round_trip_on_every_leaf(ref):
    _, _, params = ref
    model = TAVModel(SPEC, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    back = dict(_flat(to_flax(model)))
    leaves = dict(_flat(params))
    assert len(leaves) == 169 and back.keys() == leaves.keys()
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_init_params_matches_flax_tree_and_scales(ref):
    _, jb, _ = ref
    drawn = dict(_flat(init_params(SPEC, seed=0)))
    leaves = dict(_flat(jax.eval_shape(lambda: j_fusion.TAVModel(
        J_SPEC).init(jax.random.PRNGKey(0), jb))["params"]))
    assert drawn.keys() == leaves.keys()
    for path, leaf in leaves.items():
        assert drawn[path].shape == leaf.shape and drawn[path].dtype == \
            np.float32, path
    word = drawn[("model", "text_encoder", "embeddings", "word", "embedding")]
    assert abs(word.std() - 32 ** -0.5) < 0.1 * 32 ** -0.5
    qkv = drawn[("model", "fusion_encoder", "layer_0", "attention", "qkv",
                 "kernel")]
    assert abs(qkv.std() - 32 ** -0.5) < 0.1 * 32 ** -0.5
    assert np.abs(qkv).max() <= 2 * 32 ** -0.5 / 0.8796 + 1e-6
    assert (drawn[("model", "text_norm", "scale")] == 1).all()
    assert (drawn[("model", "classifier", "bias")] == 0).all()


def _check(ours, theirs, atol=1e-5):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               atol=atol, rtol=1e-5)


def test_text_tower_fp32(ref):
    batch, jb, params = ref
    sub = params["model"]["text_encoder"]
    seq, pooled = jax.jit(lambda p, i, m: j_text.TextEncoder(
        J_SPEC.text).apply({"params": p}, i, m))(
            sub, jb["input_ids"], jb["text_mask"])
    m = TextEncoder(SPEC.text, device="cpu")
    m.load_state_dict(from_flax(sub))
    m.eval()
    with torch.inference_mode():
        o_seq, o_pooled = m(torch.from_numpy(batch["input_ids"]),
                            torch.from_numpy(batch["text_mask"]))
    _check(o_seq, seq)
    _check(o_pooled, pooled)


def test_audio_tower_fp32(ref):
    batch, jb, params = ref
    sub = params["model"]["wav2vec2"]
    hidden, norm, mask = jax.jit(lambda p, w, am: j_audio.Wav2Vec2Model(
        J_SPEC.audio).apply({"params": p}, w, am))(
            sub, jb["waveform"], jb["audio_mask"])
    m = Wav2Vec2Model(SPEC.audio, device="cpu")
    m.load_state_dict(from_flax(sub))
    m.eval()
    with torch.inference_mode():
        o_hidden, o_norm, o_mask = m(torch.from_numpy(batch["waveform"]),
                                     torch.from_numpy(batch["audio_mask"]))
    _check(o_hidden, hidden)
    _check(o_norm, norm)
    np.testing.assert_array_equal(o_mask.numpy(), np.asarray(mask))


def test_video_tower_fp32(ref):
    batch, jb, params = ref
    sub = params["model"]["videomae"]
    n_keep = SPEC.video.num_patches - SPEC.video_keep_k
    visible = np.logical_not(batch["video_keep"])
    out = jax.jit(lambda p, v, k: j_video.VideoMAEModel(J_SPEC.video).apply(
        {"params": p}, v, k, n_keep))(sub, jb["video"], jnp.asarray(visible))
    m = VideoMAEModel(SPEC.video, device="cpu")
    m.load_state_dict(from_flax(sub))
    m.eval()
    with torch.inference_mode():
        o = m(torch.from_numpy(batch["video"]), torch.from_numpy(visible),
              n_keep)
    _check(o, out)


def test_preformer_fp32(ref):
    batch, jb, params = ref
    sub = params["preformer"]
    fused, types, keep = jax.jit(lambda p, b: j_fusion.PreFormer(
        J_SPEC).apply({"params": p}, b["input_ids"], b["text_mask"],
                      b["waveform"], b["audio_mask"], b["video"],
                      b["video_keep"]))(sub, jb)
    m = PreFormer(SPEC, device="cpu")
    m.load_state_dict(from_flax(sub), strict=True)
    m.eval()
    tb = _torch(batch)
    with torch.inference_mode():
        o_fused, o_types, o_keep = m(
            tb["input_ids"], tb["text_mask"], tb["waveform"],
            tb["audio_mask"], tb["video"], tb["video_keep"])
    _check(o_fused, fused)
    np.testing.assert_array_equal(o_types.numpy(), np.asarray(types))
    np.testing.assert_array_equal(o_keep.numpy(), np.asarray(keep))


def _logits(spec, j_spec, params, batch, jb):
    want = np.asarray(jax.jit(lambda p, b: j_fusion.TAVModel(j_spec).apply(
        {"params": p}, b))(params, jb).astype(jnp.float32))
    model = TAVModel(spec, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    model.eval()
    with torch.inference_mode():
        got = model(_torch(batch))
    assert got.dtype == torch.float32 and got.shape == (3, 7)
    return got.numpy(), want


@pytest.mark.parametrize("share_audio_frontend", [False, True])
def test_tav_logits_fp32(ref, share_audio_frontend):
    batch, jb, params = ref
    if share_audio_frontend:
        # the shared-frontend tree: the PreFormer's and the audio tower's
        # conv stacks fold into one top-level ``audio_frontend``
        params = dict(params)
        params["audio_frontend"] = params["preformer"]["feature_extractor"]
        params["preformer"] = {k: v for k, v in params["preformer"].items()
                               if k != "feature_extractor"}
        params["model"] = dict(params["model"])
        params["model"]["wav2vec2"] = {
            k: v for k, v in params["model"]["wav2vec2"].items()
            if k != "feature_extractor"}
    spec = dataclasses.replace(SPEC, share_audio_frontend=share_audio_frontend)
    j_spec = dataclasses.replace(J_SPEC,
                                 share_audio_frontend=share_audio_frontend)
    got, want = _logits(spec, j_spec, params, batch, jb)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tav_logits_bf16_agreement(ref):
    batch, jb, params = ref
    fp32, _ = _logits(SPEC, J_SPEC, params, batch, jb)
    got, want = _logits(SPEC.with_compute_dtype(torch.bfloat16),
                        J_SPEC.with_compute_dtype(jnp.bfloat16), params,
                        batch, jb)
    np.testing.assert_allclose(got, want, atol=5e-2)
    np.testing.assert_allclose(got, fp32, atol=5e-2)
    np.testing.assert_allclose(want, fp32, atol=5e-2)
