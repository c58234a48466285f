"""The port's pretrained-weight import (mme_tpu_torch/models/hf_import.py,
models/pretrained.py with its own ``.safetensors`` reader, the
``MME_PRETRAINED`` branch of the four CLIs) against mme_tpu and against
HF's own forward, on tiny HF models built from configs here (nothing is
downloaded).

- Converters: the port's flax-layout tree equals JAX's leaf for leaf (the
  same paths, dtypes and values, ``np.array_equal``) on the same state
  dicts; both are numpy.
- Towers: the port's modules loaded through ``convert.from_flax`` against
  the HF model's fp32 forward, at the JAX parity tests' tolerances
  (``ATOL`` of tests/test_text_parity.py 2e-5, test_audio_parity.py 3e-5,
  test_video_parity.py 3e-5, test_image_visualbert_parity.py 1e-4;
  slow_r50 ``rtol = atol = 2e-4`` as tests/test_slow_r50_import.py).
- Loaders against JAX's on the same files; at full width on shape-only
  trees (the port's from a ``meta`` model through
  ``convert.flax_shapes``, JAX's through ``jax.eval_shape``) with files
  whose tensors are zero-stride stand-ins of HF's full-width layouts built
  on ``torch.device("meta")``: no full-width model is materialised.
- ``chip_smoke.py``'s phase-12 layouts against the ``state_dict()`` of the
  matching ``transformers`` classes on ``meta``.
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import transformers

import jax
import jax.numpy as jnp

from mme_tpu.models import audio as j_audio
from mme_tpu.models import fusion as j_fusion
from mme_tpu.models import hf_import as j_hf
from mme_tpu.models import layers as j_layers
from mme_tpu.models import pretrained as j_pretrained
from mme_tpu.models import text as j_text
from mme_tpu.models import video as j_video
from mme_tpu.models import visualbert as j_visualbert
from mme_tpu.train.build_tav import example_tav_batch as j_example_tav_batch

from mme_tpu_torch.cli import audio_nn_wav2vec, tav_nn, text_nn, visual_nn
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import (ShapeDtype, flax_shapes, from_flax,
                                   init_params, init_variables, to_flax)
from mme_tpu_torch.models import audio, fusion, hf_import, image, layers
from mme_tpu_torch.models import pretrained, text, video, visualbert

from test_slow_r50_import import (STAGES as SLOW_STAGES, make_state_dict,
                                  torch_slow_pooled)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

J = types.SimpleNamespace(layers=j_layers, text=j_text, audio=j_audio,
                          video=j_video, visualbert=j_visualbert)
P = types.SimpleNamespace(layers=layers, text=text, audio=audio,
                          video=video, visualbert=visualbert)
TEXT_ATOL, AUDIO_ATOL, VIDEO_ATOL, IMAGE_ATOL, SLOW_TOL = (2e-5, 3e-5, 3e-5,
                                                          1e-4, 2e-4)


# ---- tiny HF models and the matching specs in both packages -------------

def _text_spec(ns, style):
    roberta = style == "roberta"
    return ns.text.TextEncoderSpec(
        vocab_size=97, max_positions=40, type_vocab_size=1 if roberta else 2,
        pad_token_id=1 if roberta else 0, position_style=style,
        encoder=ns.layers.EncoderSpec(hidden=32, heads=4, layers=3,
                                      intermediate=64, ln_style="post",
                                      ln_eps=1e-5 if roberta else 1e-12))


def _audio_spec(ns, stable):
    return ns.audio.Wav2Vec2Spec(
        conv_dims=(8, 8, 8), conv_kernels=(10, 3, 3), conv_strides=(5, 2, 2),
        conv_bias=stable, feat_extract_norm="layer" if stable else "group",
        do_stable_layer_norm=stable, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        encoder=ns.layers.EncoderSpec(hidden=24, heads=4, layers=2,
                                      intermediate=48,
                                      ln_style="pre" if stable else "post",
                                      ln_eps=1e-5, final_ln=stable))


def _video_spec(ns):
    return ns.video.VideoMAESpec(
        image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
        encoder=ns.layers.EncoderSpec(hidden=24, heads=4, layers=2,
                                      intermediate=48, ln_style="pre",
                                      qkv_bias="qv", ln_eps=1e-12))


def _visualbert_spec(ns):
    return ns.visualbert.VisualBertSpec(
        vocab_size=99, max_positions=40, type_vocab_size=2,
        visual_embedding_dim=20,
        encoder=ns.layers.EncoderSpec(hidden=32, heads=4, layers=2,
                                      intermediate=64, ln_style="post",
                                      ln_eps=1e-12))


def _hf_text(style):
    kw = dict(vocab_size=97, hidden_size=32, num_hidden_layers=3,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=40, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    if style == "roberta":
        return transformers.RobertaModel(transformers.RobertaConfig(
            type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5, **kw))
    return transformers.BertModel(transformers.BertConfig(
        type_vocab_size=2, pad_token_id=0, layer_norm_eps=1e-12, **kw))


def _hf_audio(stable):
    torch.manual_seed(3 + stable)
    return transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=24, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48, conv_dim=(8, 8, 8),
        conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), conv_bias=stable,
        feat_extract_norm="layer" if stable else "group",
        do_stable_layer_norm=stable, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        layerdrop=0.0, apply_spec_augment=False))


def _hf_video():
    torch.manual_seed(4)
    return transformers.VideoMAEModel(transformers.VideoMAEConfig(
        image_size=32, patch_size=8, num_frames=4, tubelet_size=2,
        hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, qkv_bias=True,
        use_mean_pooling=True))


def _hf_resnet(head):
    torch.manual_seed(6)
    cfg = transformers.ResNetConfig(embedding_size=64,
                                    hidden_sizes=[256, 512, 1024, 2048],
                                    depths=[3, 4, 6, 3],
                                    layer_type="bottleneck", num_labels=10)
    return (transformers.ResNetForImageClassification(cfg) if head
            else transformers.ResNetModel(cfg))


def _hf_visualbert():
    torch.manual_seed(7)
    return transformers.VisualBertForPreTraining(transformers.VisualBertConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=2,
        visual_embedding_dim=20, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12,
        special_visual_initialize=False))


def _weight_norm_form(sd, form):
    """The positional conv's weight norm as HF's ``weight_g`` /
    ``weight_v`` keys (older files), as torch's parametrization keys, or
    folded into a dense ``weight``."""
    out = {}
    for k, v in sd.items():
        if "parametrizations.weight.original" not in k:
            out[k] = v
            continue
        stem = k.split(".parametrizations.")[0]
        if form == "weight_g":
            out[f"{stem}.weight_{'g' if k.endswith('0') else 'v'}"] = v
        elif form == "dense" and k.endswith("0"):
            g, w = v, sd[f"{stem}.parametrizations.weight.original1"]
            out[f"{stem}.weight"] = (g * w / np.sqrt(
                (w ** 2).sum(axis=(0, 1), keepdims=True))).astype(np.float32)
        elif form == "parametrizations":
            out[k] = v
    return out


_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _case(name):
    """(HF model or None, state dict, JAX converter call, port converter
    call) of one converter case."""
    if name in ("roberta", "bert"):
        hf = _cached(name, lambda: _hf_text(name))
        return (hf, j_hf.state_dict_np(hf),
                lambda sd: j_hf.convert_text_encoder(sd, _text_spec(J, name)),
                lambda sd: hf_import.convert_text_encoder(
                    sd, _text_spec(P, name)))
    if name.startswith("wav2vec2"):
        _, mode, form = name.split("_", 2)
        stable = mode == "layer"
        hf = _cached(mode, lambda: _hf_audio(stable))
        return (hf, _weight_norm_form(j_hf.state_dict_np(hf), form),
                lambda sd: j_hf.convert_wav2vec2(sd, _audio_spec(J, stable)),
                lambda sd: hf_import.convert_wav2vec2(
                    sd, _audio_spec(P, stable)))
    if name == "videomae":
        hf = _cached(name, _hf_video)
        return (hf, j_hf.state_dict_np(hf),
                lambda sd: j_hf.convert_videomae(sd, _video_spec(J)),
                lambda sd: hf_import.convert_videomae(sd, _video_spec(P)))
    if name.startswith("resnet"):
        head = name == "resnet_head"
        hf = _cached(name, lambda: _hf_resnet(head))
        return hf, j_hf.state_dict_np(hf), j_hf.convert_resnet50, \
            hf_import.convert_resnet50
    if name == "visualbert":
        hf = _cached(name, _hf_visualbert)
        return (hf, j_hf.state_dict_np(hf),
                lambda sd: j_hf.convert_visualbert_pretraining(
                    sd, _visualbert_spec(J)),
                lambda sd: hf_import.convert_visualbert_pretraining(
                    sd, _visualbert_spec(P)))
    assert name.startswith("slow_r50")
    sd = _cached("slow_r50", lambda: make_state_dict(
        np.random.RandomState(0)))
    if name == "slow_r50_nested":
        sd = {f"model_state.{k}": v for k, v in sd.items()}
    return (None, sd, lambda x: j_hf.convert_slow_r50(x, SLOW_STAGES),
            lambda x: hf_import.convert_slow_r50(x, SLOW_STAGES))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


CONVERTERS = ("roberta", "bert", "wav2vec2_group_weight_g",
              "wav2vec2_group_parametrizations", "wav2vec2_group_dense",
              "wav2vec2_layer_weight_g", "wav2vec2_layer_parametrizations",
              "videomae", "resnet", "resnet_head", "visualbert", "slow_r50",
              "slow_r50_nested")


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_matches_jax(name):
    """Every converter's tree equals JAX's leaf for leaf on one state
    dict: BERT with token types, RoBERTa, wav2vec2 in group/post-LN and
    layer/stable modes with each positional-conv key form, VideoMAE,
    ResNetModel and the classifier layout, VisualBERT pre-training and
    slow_r50, plain and nested under ``model_state``."""
    _, sd, j_convert, convert = _case(name)
    want = dict(_leaves(j_convert(sd)))
    got = dict(_leaves(convert(sd)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray), k
        assert g.dtype == np.asarray(w).dtype, k
        assert np.array_equal(g, w), k


def test_state_dict_np_takes_modules_tensors_and_arrays():
    hf = _cached("roberta", lambda: _hf_text("roberta"))
    want = j_hf.state_dict_np(hf)
    for source in (hf, hf.state_dict(), want):
        got = hf_import.state_dict_np(source)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)


# ---- the towers against HF's forward ------------------------------------

def _text_inputs(seed, batch, seq, pad_id):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 97, size=(batch, seq))
    lengths = rng.randint(seq // 2, seq + 1, size=batch)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    return np.where(mask == 1, ids, pad_id), mask


def _port(cls, flax, *args, stats=None):
    m = cls(*args, device="cpu")
    m.load_state_dict(from_flax(flax, stats), strict=True)
    return m.eval()


@pytest.mark.parametrize("name", ["roberta", "bert", "wav2vec2_group",
                                  "wav2vec2_layer", "videomae", "resnet",
                                  "visualbert", "slow_r50"])
def test_tower_matches_hf_forward(name):
    """The port's tower loaded from the converted HF weights gives HF's
    own fp32 outputs (non-pad positions) within the JAX tests'
    tolerances."""
    torch.manual_seed(0)
    with torch.no_grad():
        if name in ("roberta", "bert"):
            hf, sd, _, convert = _case(name)
            ids, mask = _text_inputs(1, 3, 24, 1 if name == "roberta" else 0)
            tt = ((np.arange(24)[None, :] >= 12) * np.ones((3, 1))).astype(
                np.int64) if name == "bert" else np.zeros_like(ids)
            ref = hf.eval()(input_ids=torch.tensor(ids),
                            attention_mask=torch.tensor(mask),
                            token_type_ids=torch.tensor(tt))
            seq, pool = _port(text.TextEncoder, convert(sd),
                              _text_spec(P, name))(
                torch.tensor(ids), torch.tensor(mask), torch.tensor(tt))
            m = mask[..., None].astype(bool)
            np.testing.assert_allclose(
                np.where(m, seq.numpy(), 0),
                np.where(m, ref.last_hidden_state.numpy(), 0),
                atol=TEXT_ATOL)
            np.testing.assert_allclose(pool.numpy(),
                                       ref.pooler_output.numpy(),
                                       atol=TEXT_ATOL)
        elif name.startswith("wav2vec2"):
            stable = name.endswith("layer")
            hf, sd, _, convert = _case(f"{name}_weight_g")
            rng = np.random.RandomState(5)
            wave = rng.randn(2, 400).astype(np.float32)
            mask = (np.arange(400)[None, :] < np.array([[400], [260]])
                    ).astype(np.int64)
            wave = (wave * mask).astype(np.float32)
            ref = hf.eval()(torch.tensor(wave),
                            attention_mask=torch.tensor(mask)
                            ).last_hidden_state.numpy()
            hidden, _, feat_mask = _port(
                audio.Wav2Vec2Model, convert(sd), _audio_spec(P, stable))(
                torch.tensor(wave), torch.tensor(mask, dtype=torch.int32))
            fm = feat_mask.numpy()[..., None].astype(bool)
            np.testing.assert_allclose(np.where(fm, hidden.numpy(), 0),
                                       np.where(fm, ref, 0), atol=AUDIO_ATOL)
        elif name == "videomae":
            hf, sd, _, convert = _case(name)
            vid = np.random.RandomState(9).randn(2, 4, 32, 32, 3).astype(
                np.float32)
            ref = hf.eval()(torch.tensor(vid.transpose(0, 1, 4, 2, 3))
                            ).last_hidden_state.numpy()
            got = _port(video.VideoMAEModel, convert(sd), _video_spec(P))(
                torch.tensor(vid))
            np.testing.assert_allclose(got.numpy(), ref, atol=VIDEO_ATOL)
        elif name == "resnet":
            hf, sd, _, convert = _case("resnet_head")
            x = np.random.RandomState(13).randn(2, 64, 64, 3).astype(
                np.float32)
            ref = hf.eval()(torch.tensor(x.transpose(0, 3, 1, 2))
                            ).logits.numpy()
            conv = convert(sd)
            logits, pooled = _port(image.ResNet50, conv["params"], 10,
                                   stats=conv["batch_stats"])(
                torch.tensor(x))
            assert pooled.shape == (2, 2048)
            np.testing.assert_allclose(logits.numpy(), ref, atol=IMAGE_ATOL)
        elif name == "visualbert":
            hf, sd, _, convert = _case(name)
            rng = np.random.RandomState(17)
            ids = rng.randint(0, 99, size=(2, 12))
            mask = np.ones((2, 12), np.int64)
            mask[1, 9:] = 0
            kw = dict(attention_mask=mask, token_type_ids=np.zeros_like(mask),
                      visual_embeds=rng.randn(2, 3, 20).astype(np.float32),
                      visual_attention_mask=np.ones((2, 3), np.int64),
                      visual_token_type_ids=np.ones((2, 3), np.int64))
            ref = hf.eval()(input_ids=torch.tensor(ids),
                            **{k: torch.tensor(v) for k, v in kw.items()}
                            ).prediction_logits.numpy()
            got = _port(visualbert.VisualBertForPreTraining, convert(sd),
                        _visualbert_spec(P))(
                torch.tensor(ids),
                **{k: torch.tensor(v) for k, v in kw.items()}).numpy()
            keep = np.concatenate([mask, kw["visual_attention_mask"]],
                                  axis=1).astype(bool)[..., None]
            np.testing.assert_allclose(np.where(keep, got, 0),
                                       np.where(keep, ref, 0),
                                       atol=IMAGE_ATOL)
        else:
            _, sd, _, convert = _case(name)
            clip = np.random.RandomState(0).randn(2, 4, 32, 32, 3).astype(
                np.float32)
            want = torch_slow_pooled(sd, clip)
            net = video.SlowR50(5, stage_sizes=SLOW_STAGES, device="cpu")
            variables = init_variables(net, 0)
            conv = convert(sd)
            params = {**variables["params"], **conv["params"]}
            net.load_state_dict(from_flax(params, conv["batch_stats"]))
            got = net.eval()(torch.tensor(clip), features_only=True)
            np.testing.assert_allclose(got.numpy(), want, rtol=SLOW_TOL,
                                       atol=SLOW_TOL)


# ---- the loaders against JAX's on the same files ------------------------

def _save(root, repo_id, sd, basename=True):
    d = os.path.join(root, repo_id.split("/")[-1] if basename else repo_id)
    os.makedirs(d, exist_ok=True)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               os.path.join(d, "pytorch_model.bin"))
    return d


def test_text_classifier_end_to_end_matches_jax(tmp_path):
    """A tiny RoBERTa classification checkpoint (``roberta.`` prefix, no
    pooler) loaded by the port's ``load_text_classifier`` and by JAX's
    into one drawn tree: the same tree, the head as drawn in both, and the
    same fp32 logits (1e-5, as tests/test_torch_text_models.py)."""
    torch.manual_seed(1)
    hf = transformers.RobertaForSequenceClassification(
        transformers.RobertaConfig(
            vocab_size=97, hidden_size=32, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
            layer_norm_eps=1e-5, num_labels=7))
    _save(str(tmp_path), pretrained.TEXT_EMOTION, hf.state_dict(),
          basename=False)
    spec, j_spec = _text_spec(P, "roberta"), _text_spec(J, "roberta")
    net = text.BertClassifier(spec, 5, 0.0, device="cpu")
    drawn = init_variables(net, 3)["params"]
    got, ok = pretrained.load_text_classifier(drawn, spec, str(tmp_path))
    want, j_ok = j_pretrained.load_text_classifier(drawn, j_spec,
                                                   str(tmp_path))
    assert ok and j_ok
    g, w, d = dict(_leaves(got)), dict(_leaves(want)), dict(_leaves(drawn))
    assert g.keys() == w.keys() == d.keys()
    assert all(np.array_equal(g[k], w[k]) for k in g)
    for k in g:                     # the head and the unused pooler: drawn
        assert (g[k] is d[k]) == (k.startswith("classifier")
                                  or k.startswith("bert/pooler")), k
    assert np.array_equal(g["bert/embeddings/word/embedding"],
                          hf.roberta.embeddings.word_embeddings.weight
                          .detach().numpy())
    net.load_state_dict(from_flax(got))
    ids, mask = _text_inputs(2, 3, 16, 1)
    with torch.no_grad():
        logits = net.eval()(torch.tensor(ids), torch.tensor(mask)).numpy()
    j_model = j_text.BertClassifier(j_spec, output_dim=5)
    j_logits = jax.jit(lambda p, i, m: j_model.apply({"params": p}, i, m))(
        want, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(logits, np.asarray(j_logits), atol=1e-5)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    return la.keys() == lb.keys() and all(
        np.array_equal(la[k], lb[k]) for k in la)


def test_audio_and_slow_r50_loaders_match_jax(tmp_path):
    """``load_audio_classifier`` (a wav2vec2-base-layout classification
    checkpoint, ``wav2vec2.`` prefix) and ``load_slow_r50`` (a
    ``SLOW_8x8_R50.pyth`` nested under ``model_state``) give JAX's flag and
    JAX's trees, params and batch statistics; an empty root loads
    nothing in both."""
    root = str(tmp_path)
    torch.manual_seed(2)
    hf = transformers.Wav2Vec2ForSequenceClassification(
        transformers.Wav2Vec2Config(
            hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, conv_dim=(8, 8, 8), conv_kernel=(10, 3, 3),
            conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, num_labels=4))
    _save(root, pretrained.AUDIO_SUPERB, hf.state_dict())
    spec, j_spec = _audio_spec(P, False), _audio_spec(J, False)
    drawn = init_variables(audio.Wav2Vec2Classifier(spec, 4, device="meta"),
                           5)["params"]
    got, ok = pretrained.load_audio_classifier(drawn, spec, root)
    want, j_ok = j_pretrained.load_audio_classifier(drawn, j_spec, root)
    assert ok and j_ok and _same_tree(got, want)
    assert not _same_tree(got["wav2vec2"], drawn["wav2vec2"])

    sd = make_state_dict(np.random.RandomState(1))
    torch.save({"model_state": sd}, tmp_path / "SLOW_8x8_R50.pyth")
    drawn = init_variables(video.SlowR50(3, stage_sizes=SLOW_STAGES,
                                         device="meta"), 6)
    got = pretrained.load_slow_r50(drawn["params"], drawn["batch_stats"],
                                   root, SLOW_STAGES)
    want = j_pretrained.load_slow_r50(drawn["params"], drawn["batch_stats"],
                                      root, SLOW_STAGES)
    assert got[2] and want[2]
    assert _same_tree(got[0], want[0]) and _same_tree(got[1], want[1])
    assert got[0]["proj"] is drawn["params"]["proj"]

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert pretrained.load_slow_r50({}, {}, empty)[2] is False
    assert pretrained.load_audio_classifier(drawn, spec, empty) == (drawn,
                                                                     False)


def _meta_state(cls, cfg):
    with torch.device("meta"):
        return cls(cfg).state_dict()


LAYOUTS = {
    "distilroberta": (transformers.RobertaForSequenceClassification,
                      lambda: transformers.RobertaConfig(
                          vocab_size=50265, max_position_embeddings=514,
                          num_hidden_layers=6, hidden_size=768,
                          num_attention_heads=12, intermediate_size=3072,
                          type_vocab_size=1, pad_token_id=1, num_labels=7)),
    "xlsr": (transformers.Wav2Vec2ForSequenceClassification,
             lambda: transformers.Wav2Vec2Config(
                 hidden_size=1024, num_hidden_layers=24,
                 num_attention_heads=16, intermediate_size=4096,
                 conv_bias=True, feat_extract_norm="layer",
                 do_stable_layer_norm=True, num_labels=8)),
    "videomae": (transformers.VideoMAEForVideoClassification,
                 lambda: transformers.VideoMAEConfig(num_labels=400)),
    "base": (transformers.Wav2Vec2ForSequenceClassification,
             lambda: transformers.Wav2Vec2Config(num_labels=4))}


def _full_width_files(root):
    """The three TAV towers' checkpoints at the reference's full geometry,
    every tensor a zero-stride stand-in (one stored element)."""
    for repo, key in ((pretrained.TEXT_EMOTION, "distilroberta"),
                      (pretrained.AUDIO_XLSR, "xlsr"),
                      (pretrained.VIDEO_MAE, "videomae")):
        cls, cfg = LAYOUTS[key]
        state = _cached(f"meta_{key}", lambda: _meta_state(cls, cfg()))
        d = os.path.join(root, repo.split("/")[-1])
        os.makedirs(d, exist_ok=True)
        torch.save({k: torch.zeros((), dtype=v.dtype).expand(v.shape)
                    for k, v in state.items()},
                   os.path.join(d, "pytorch_model.bin"))


@pytest.mark.parametrize("shared", [False, True])
def test_load_tav_full_width_matches_jax(shared, tmp_path):
    """``load_tav`` at full width on shape-only trees: the port's from a
    ``meta`` model, JAX's from ``jax.eval_shape``; both load the same leaf
    paths at the same shapes from the same files and leave the same paths
    untouched, with the shared audio frontend off and on."""
    _full_width_files(str(tmp_path))
    spec = dataclasses.replace(fusion.TAVSpec(output_dim=7),
                               share_audio_frontend=shared)
    j_spec = dataclasses.replace(j_fusion.TAVSpec(output_dim=7),
                                 share_audio_frontend=shared)
    shapes = flax_shapes(fusion.TAVModel(spec, device="meta"))
    j_model = j_fusion.TAVModel(j_spec)
    batch = j_example_tav_batch(j_spec, 1, 70, 16000)
    j_shapes = jax.eval_shape(
        lambda: j_model.init(jax.random.PRNGKey(0), batch))["params"]
    got, names = pretrained.load_tav(shapes, spec, str(tmp_path))
    want, j_names = j_pretrained.load_tav(j_shapes, j_spec, str(tmp_path))
    assert names == j_names == [pretrained.TEXT_EMOTION,
                                pretrained.AUDIO_XLSR, pretrained.VIDEO_MAE]
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    loaded = {k for k, v in g.items() if isinstance(v, np.ndarray)}
    assert loaded == {k for k, v in w.items() if isinstance(v, np.ndarray)}
    assert all(isinstance(g[k], ShapeDtype) for k in g.keys() - loaded)
    assert all(g[k].shape == w[k].shape for k in g)
    assert ("audio_frontend/conv_0/kernel" in loaded) == shared
    assert ("preformer/feature_extractor/conv_0/kernel" in loaded) != shared
    assert "model/fusion_encoder/layer_0/attention/qkv/kernel" not in loaded
    assert "model/text_encoder/pooler/kernel" not in loaded


# ---- chip_smoke.py's checkpoint layouts ---------------------------------

@pytest.mark.parametrize("name", ["distilroberta", "xlsr", "videomae",
                                  "base", "slow_r50"])
def test_chip_smoke_layouts_are_the_real_ones(name):
    """Phase 12 writes the reference's layouts: its name → shape tables
    equal the ``state_dict()`` of the ``transformers`` classes at the
    reference checkpoints' configs (xlsr's positional conv in the older
    ``weight_g`` / ``weight_v`` form), and slow_r50's equals the layout
    of tests/test_slow_r50_import.py."""
    spec = fusion.TAVSpec(output_dim=7)
    tables = {e[0]: e[3] for e in chip_smoke.pretrained_checkpoints(
        spec, audio.Wav2Vec2Spec.base(), SLOW_STAGES)}
    if name == "slow_r50":
        want = {k: tuple(v.shape) for k, v in make_state_dict(
            np.random.RandomState(0)).items()}
        assert tables[pretrained.SLOW_R50] == want
        return
    repo = {"distilroberta": pretrained.TEXT_EMOTION,
            "xlsr": pretrained.AUDIO_XLSR, "videomae": pretrained.VIDEO_MAE,
            "base": pretrained.AUDIO_SUPERB}[name]
    cls, cfg = LAYOUTS[name]
    state = _cached(f"meta_{name}", lambda: _meta_state(cls, cfg()))
    want = {k: tuple(v.shape) for k, v in state.items()}
    if name == "xlsr":
        want = {k.replace("parametrizations.weight.original0", "weight_g")
                .replace("parametrizations.weight.original1", "weight_v"): v
                for k, v in want.items()}
    assert tables[repo] == want


def test_chip_smoke_phase12_checks_hold_at_the_tiny_size(tmp_path):
    """Phase 12's writer, timing loop and leaf checks on the CPU at the
    tiny spec: the five checkpoints written as the card's phase writes
    them (safetensors by its own writer, read back by the safetensors
    package too), read, converted and merged by ``checkpoint_times``,
    loaded by ``load_tav`` and ``load_slow_r50``, and every check of
    ``tav_leaf_checks`` / ``slow_r50_checks`` holds."""
    from safetensors.numpy import load_file
    spec = fusion.TAVSpec(output_dim=7).tiny()
    base = audio_nn_wav2vec.tiny_spec(audio.Wav2Vec2Spec.base())
    root = str(tmp_path)
    entries = chip_smoke.pretrained_checkpoints(spec, base, SLOW_STAGES)
    rng = np.random.default_rng(0)
    written = {e[0]: chip_smoke.write_checkpoint(root, e, rng)
               for e in entries}
    files, times = chip_smoke.checkpoint_times(root, entries, spec, base,
                                               SLOW_STAGES, device="cpu")
    for repo, _, name, layout in entries:
        assert {k: v.shape for k, v in files[repo].items()} == layout
        assert times[repo]["filled"] > 0
        if name.endswith(".safetensors"):
            ref = load_file(written[repo]["path"])
            assert ref.keys() == files[repo].keys()
            assert all(np.array_equal(ref[k], files[repo][k]) for k in ref)
    init = init_params(spec, 0)
    params, loaded = pretrained.load_tav(init, spec, root)
    assert loaded == [pretrained.TEXT_EMOTION, pretrained.AUDIO_XLSR,
                      pretrained.VIDEO_MAE]
    model = fusion.TAVModel(spec, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    checks = chip_smoke.tav_leaf_checks(model, files, init, spec)
    assert checks["ok"], checks
    net = video.SlowR50(7, stage_sizes=SLOW_STAGES, device="cpu")
    drawn = init_variables(net, 0)
    p, s, ok = pretrained.load_slow_r50(drawn["params"], drawn["batch_stats"],
                                        root, SLOW_STAGES)
    net.load_state_dict(from_flax(p, s))
    checks = chip_smoke.slow_r50_checks(net, files[pretrained.SLOW_R50],
                                        SLOW_STAGES)
    assert ok and checks["stem_conv"] and checks["bn_buffers_equal"]
    assert checks["bn_buffers"] == 34


# ---- the safetensors reader ---------------------------------------------

def test_safetensors_reader_matches_the_package(tmp_path):
    """The port's reader gives what ``safetensors.numpy.load_file`` gives
    on a file of every numpy dtype the format has (with ``__metadata__``, a
    0-d and an empty tensor), on ``save_pretrained(safe_serialization=
    True)``'s file and on ``chip_smoke.write_safetensors``'s."""
    from safetensors.numpy import load_file, save_file
    rng = np.random.RandomState(0)
    arrays = {name: (rng.randn(3, 5) * 50).astype(name)
              for name in chip_smoke.SAFETENSORS_CODES if name != "bool"}
    arrays["complex64"] = arrays["complex64"] + 1j
    arrays["bool"] = rng.rand(4, 2) > 0.5
    arrays["scalar"] = np.array(2.5, np.float32)
    arrays["empty"] = np.zeros((0, 3), np.float32)
    save_file(arrays, str(tmp_path / "all.safetensors"),
              metadata={"format": "np"})
    chip_smoke.write_safetensors(str(tmp_path / "own.safetensors"), arrays,
                                 {"format": "np"})
    hf = _cached("roberta", lambda: _hf_text("roberta"))
    hf.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    for path in ("all.safetensors", "own.safetensors",
                 "hf/model.safetensors"):
        want = load_file(str(tmp_path / path))
        got = pretrained._read_safetensors(str(tmp_path / path))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert np.array_equal(got[k], w), k
        if path != "hf/model.safetensors":
            assert all(np.array_equal(got[k], arrays[k]) for k in arrays)
    got = pretrained.load_local_state_dict(str(tmp_path / "hf"))
    assert got.keys() == hf.state_dict().keys()


def test_safetensors_bf16_as_the_package(tmp_path):
    """A BF16 tensor: the reader adds no conversion of its own. In this
    process JAX's ml_dtypes has given numpy a ``bfloat16``, so both give
    the same array; without it both raise ``TypeError: data type
    'bfloat16' not understood`` (tests/test_torch_serve.py, with JAX
    blocked)."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file
    path = str(tmp_path / "bf16.safetensors")
    save_file({"w": torch.arange(3, dtype=torch.bfloat16)}, path)
    want = load_file(path)["w"]
    got = pretrained.load_local_state_dict(path)["w"]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the package's own refusal without ml_dtypes, the message the blocked
    # run of tests/test_torch_serve.py holds the reader to
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['ml_dtypes'] = None\n"
         "from safetensors.numpy import load_file\n"
         "try:\n    load_file(sys.argv[1])\n"
         "except TypeError as e:\n    print(e)\n", path],
        capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "data type 'bfloat16' not understood", \
        out.stderr


# ---- small cases --------------------------------------------------------

def test_merge_params_refuses_a_shape_mismatch_and_takes_shapes():
    for mod in (pretrained, j_pretrained):
        with pytest.raises(ValueError, match="shape mismatch at /a"):
            mod.merge_params({"a": np.zeros((2, 2))}, {"a": np.zeros((3, 2))})
    merged, missing, extra = pretrained.merge_params(
        {"a": ShapeDtype((2,), np.dtype(np.float32)), "b": np.ones(1)},
        {"a": np.arange(2.0), "c": np.ones(1)})
    assert merged["a"].dtype == np.float32 and missing == ["/b"]
    assert extra == ["/c"]


def test_inject_refuses_uninitialized_leaves_as_jax():
    params = {"t": {"w": np.zeros(2), "v": np.zeros(2)}}
    msgs = []
    for mod in (pretrained, j_pretrained):
        with pytest.raises(ValueError) as err:
            mod._inject(params, ("t",), {"w": np.ones(2)}, (), "repo")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "left model leaves uninitialized" in \
        msgs[0]


def test_strip_model_prefix_and_roots(tmp_path, monkeypatch):
    sd = {"roberta.embeddings.word_embeddings.weight": np.zeros((4, 4)),
          "classifier.weight": np.zeros((2, 4))}
    assert pretrained.strip_model_prefix(sd).keys() == \
        j_pretrained.strip_model_prefix(sd).keys() == \
        {"embeddings.word_embeddings.weight"}
    base = {"feature_projection.projection.weight": np.zeros(1)}
    assert pretrained.strip_model_prefix(base) == base
    monkeypatch.delenv("MME_PRETRAINED", raising=False)
    assert pretrained.pretrained_root() is None
    assert pretrained.pretrained_root(str(tmp_path / "absent")) is None
    monkeypatch.setenv("MME_PRETRAINED", str(tmp_path))
    assert pretrained.pretrained_root() == str(tmp_path)
    assert pretrained.find_checkpoint_dir(str(tmp_path), "a/b") is None
    with pytest.raises(FileNotFoundError):
        pretrained.load_local_state_dict(str(tmp_path))


# ---- the CLIs' MME_PRETRAINED branch ------------------------------------

@pytest.fixture()
def tiny_root(tmp_path, monkeypatch):
    """MME_PRETRAINED naming a directory of checkpoints at the tiny specs'
    geometry, written as phase 12 writes them; the CLIs run from
    ``tmp_path`` with their training stubbed (each returns the model it
    would train)."""
    root = tmp_path / "pretrained"
    spec = fusion.TAVSpec(output_dim=7).tiny()
    base = audio_nn_wav2vec.tiny_spec(audio.Wav2Vec2Spec.base())
    rng = np.random.default_rng(1)
    for e in chip_smoke.pretrained_checkpoints(spec, base, SLOW_STAGES):
        chip_smoke.write_checkpoint(str(root), e, rng)
    monkeypatch.setenv("MME_PRETRAINED", str(root))
    monkeypatch.chdir(tmp_path)
    for mod in (tav_nn, text_nn, audio_nn_wav2vec, visual_nn):
        monkeypatch.setattr(mod, "run_classifier",
                            lambda cfg, model, *a, **k: {"model": model})
    return str(root)


def test_cli_gates_load_nothing_where_jax_loads_nothing(tiny_root, capsys):
    """With MME_PRETRAINED set, the tiny runs of the four CLIs raise
    nothing. JAX's gates stay shut at these sizes for ``tav_nn`` (width
    768), ``text_nn`` (the full vocabulary; never the LSTM) and
    ``audio_nn_wav2vec`` (the full conv stack), so their weights are the
    seed's draw; ``visual_nn -m ResNet`` loads at any size."""
    argv = ["--dataset", "synthetic", "-e", "1", "-b", "8"]
    seed = ExperimentConfig().seed
    for mod, extra, draw in (
            (tav_nn, [], lambda m: init_params(m.spec, seed)),
            (text_nn, [], None), (text_nn, ["-m", "LSTM"], None),
            (audio_nn_wav2vec, [], None)):
        model = mod.main(argv + extra, device="cpu")["model"]
        net = getattr(model, "net", model)
        want = draw(net) if draw else init_variables(net, seed)["params"]
        assert _same_tree(to_flax(net), want)
        assert "loaded pretrained" not in capsys.readouterr().out
    model = visual_nn.main(argv + ["-m", "ResNet"], device="cpu")["model"]
    assert "loaded pretrained slow_r50 backbone" in capsys.readouterr().out
    sd = hf_import.state_dict_np(torch.load(
        os.path.join(tiny_root, "slow_r50.pyth"),
        weights_only=True)["model_state"])
    checks = chip_smoke.slow_r50_checks(model.net, sd, SLOW_STAGES)
    assert checks["stem_conv"] and checks["bn_buffers_equal"]
    drawn = init_variables(model.net, seed)["params"]
    assert np.array_equal(to_flax(model.net)["proj"]["kernel"],
                          drawn["proj"]["kernel"])


def test_cli_branches_load_where_jax_gates_open(tiny_root, capsys):
    """The open gates through each CLI's own branch on small models that
    meet them: ``tav_nn.build_model`` at width 768 (tiny towers) loads the
    three towers and prints them; ``text_nn.load_weights`` with the full
    vocabulary and ``audio_nn_wav2vec.load_weights`` with the full conv
    stack load their towers; every head stays as drawn."""
    root = tiny_root
    tiny = fusion.TAVSpec(output_dim=7).tiny()
    spec = dataclasses.replace(tiny, hidden=768, fusion=dataclasses.replace(
        tiny.fusion, hidden=768, heads=4, layers=1))
    cfg = ExperimentConfig(output_dim=7, seed=0)
    model = tav_nn.build_model(cfg, spec, "cpu")
    out = capsys.readouterr().out
    assert out.count("loaded pretrained tower: ") == 3
    files = {repo: pretrained.load_local_state_dict(
        pretrained.find_checkpoint_dir(root, repo))
        for repo in (pretrained.TEXT_EMOTION, pretrained.AUDIO_XLSR,
                     pretrained.VIDEO_MAE)}
    assert chip_smoke.tav_leaf_checks(model, files, init_params(spec, 0),
                                      spec)["ok"]

    rng = np.random.default_rng(2)
    tspec = dataclasses.replace(_text_spec(P, "roberta"), vocab_size=50265,
                                max_positions=514)
    chip_smoke.write_checkpoint(root, (
        pretrained.TEXT_EMOTION, pretrained.TEXT_EMOTION, "model.safetensors",
        chip_smoke.roberta_layout(tspec, 7)), rng)
    net = text.BertClassifier(tspec, 7, device="cpu")
    text_nn.load_weights(net, tspec, 0)
    assert "loaded pretrained text tower" in capsys.readouterr().out
    sd = pretrained.load_local_state_dict(
        pretrained.find_checkpoint_dir(root, pretrained.TEXT_EMOTION))
    assert torch.equal(net.bert.embeddings.word.weight, torch.from_numpy(
        sd["roberta.embeddings.word_embeddings.weight"]))
    drawn = init_variables(net, 0)["params"]
    assert np.array_equal(to_flax(net)["classifier"]["kernel"],
                          drawn["classifier"]["kernel"])

    aspec = dataclasses.replace(audio.Wav2Vec2Spec.base(),
                                encoder=_audio_spec(P, False).encoder,
                                num_conv_pos_embeddings=16,
                                num_conv_pos_embedding_groups=4)
    chip_smoke.write_checkpoint(root, (
        pretrained.AUDIO_SUPERB, "wav2vec2-base-superb-er",
        "pytorch_model.bin",
        chip_smoke.wav2vec2_layout(aspec, 4, "parametrizations")), rng)
    net = audio.Wav2Vec2Classifier(aspec, 4, device="cpu")
    audio_nn_wav2vec.load_weights(net, aspec, 0)
    assert "loaded pretrained audio tower" in capsys.readouterr().out
    sd = pretrained.strip_model_prefix(pretrained.load_local_state_dict(
        pretrained.find_checkpoint_dir(root, pretrained.AUDIO_SUPERB)))
    assert torch.equal(net.wav2vec2.feature_projection.projection.weight,
                       torch.from_numpy(
                           sd["feature_projection.projection.weight"]))
    assert chip_smoke.fold_rel_err(
        net.wav2vec2.encoder.pos_conv.conv.weight,
        chip_smoke.pos_conv_fold(sd, "encoder.pos_conv_embed.conv")) <= \
        chip_smoke.POS_FOLD_RTOL
