"""HF / torch checkpoint → flax-layout parameter trees.

Port of ``mme_tpu/models/hf_import.py``, numpy only. The converters map the
``state_dict`` of a pretrained HF / pytorchvideo checkpoint onto the flax
parameter tree of the matching model, leaf for leaf as JAX's do; the port
then loads that tree through ``convert.from_flax``, so the layout changes
(q/k/v fused into one ``qkv`` kernel [hidden, 3, heads, head_dim], conv
kernels transposed, the positional conv's weight norm folded) are this
module's and ``from_flax``'s, the same code paths as every other weight
of the port.

Converters take a torch module, a torch ``state_dict`` or a
``{name: numpy array}`` dict. torch ``nn.Linear`` stores [out, in], flax
[in, out].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np

from mme_tpu_torch.models.audio import Wav2Vec2Spec
from mme_tpu_torch.models.text import TextEncoderSpec
from mme_tpu_torch.models.video import VideoMAESpec


def state_dict_np(model_or_sd: Any) -> Dict[str, np.ndarray]:
    """A module's ``state_dict()``, a state dict of tensors or a dict of
    arrays → ``{name: numpy array}``."""
    if hasattr(model_or_sd, "state_dict"):
        sd = model_or_sd.state_dict()
    else:
        sd = model_or_sd
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _layernorm(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def fuse_qkv(sd: Mapping[str, np.ndarray], q: str, k: str, v: str,
             heads: int) -> Dict[str, np.ndarray]:
    """Separate q/k/v Linears → ``{"qkv": {"kernel"}, "qkv_bias"}`` (the
    bias only when one of the three has one; a missing one is zero)."""
    qw, kw, vw = sd[f"{q}.weight"].T, sd[f"{k}.weight"].T, sd[f"{v}.weight"].T
    hidden_in, hidden_out = qw.shape
    head_dim = hidden_out // heads
    kernel = np.stack([qw, kw, vw], axis=1).reshape(
        hidden_in, 3, heads, head_dim)
    out: Dict[str, Any] = {"qkv": {"kernel": kernel}}
    zeros = np.zeros(hidden_out, qw.dtype)
    biases = [sd.get(f"{n}.bias", zeros) for n in (q, k, v)]
    if any(f"{n}.bias" in sd for n in (q, k, v)):
        out["qkv_bias"] = np.stack(biases, 0).reshape(3, heads, head_dim)
    return out


def convert_bert_layer(sd: Mapping[str, np.ndarray], prefix: str,
                       heads: int) -> Dict[str, Any]:
    """One HF BERT/RoBERTa encoder layer → the post-LN ``EncoderBlock``
    tree."""
    attn = fuse_qkv(sd, f"{prefix}.attention.self.query",
                    f"{prefix}.attention.self.key",
                    f"{prefix}.attention.self.value", heads)
    attn["out"] = _linear(sd, f"{prefix}.attention.output.dense")
    return {
        "attention": attn,
        "ln1": _layernorm(sd, f"{prefix}.attention.output.LayerNorm"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.intermediate.dense"),
            "fc2": _linear(sd, f"{prefix}.output.dense"),
        },
        "ln2": _layernorm(sd, f"{prefix}.output.LayerNorm"),
    }


def convert_text_encoder(model_or_sd: Any, spec: TextEncoderSpec,
                         prefix: str = "") -> Dict[str, Any]:
    """HF ``RobertaModel`` / ``BertModel`` → ``TextEncoder`` params, the
    pooler when the checkpoint has one. ``prefix`` picks a submodule of a
    larger checkpoint (e.g. ``"bert."`` inside a classifier)."""
    sd = state_dict_np(model_or_sd)
    p = prefix
    heads = spec.encoder.heads
    embeddings = {
        "word": {"embedding": sd[f"{p}embeddings.word_embeddings.weight"]},
        "position": {
            "embedding": sd[f"{p}embeddings.position_embeddings.weight"]},
        "token_type": {
            "embedding": sd[f"{p}embeddings.token_type_embeddings.weight"]},
        "ln": _layernorm(sd, f"{p}embeddings.LayerNorm"),
    }
    encoder = {
        f"layer_{i}": convert_bert_layer(sd, f"{p}encoder.layer.{i}", heads)
        for i in range(spec.encoder.layers)
    }
    params: Dict[str, Any] = {
        "embeddings": embeddings,
        "encoder": encoder,
    }
    if f"{p}pooler.dense.weight" in sd:
        params["pooler"] = _linear(sd, f"{p}pooler.dense")
    return params


def _conv1d(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """torch Conv1d [out, in/g, k] → flax [k, in/g, out]."""
    p = {"kernel": sd[f"{prefix}.weight"].transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _pos_conv_kernel(sd: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """Fold torch's weight norm (dim=2: the norm over axes 0 and 1) back
    into a dense conv kernel, in flax's [k, in/g, out]. HF stores
    ``weight_g`` / ``weight_v`` (older files) or
    ``parametrizations.weight.original0`` / ``original1``; a dense
    ``weight`` is taken as it is."""
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        return sd[f"{prefix}.weight"].transpose(2, 1, 0)
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)
    return w.transpose(2, 1, 0)


def convert_wav2vec2_layer(sd: Mapping[str, np.ndarray], prefix: str,
                           heads: int) -> Dict[str, Any]:
    attn = fuse_qkv(sd, f"{prefix}.attention.q_proj",
                    f"{prefix}.attention.k_proj",
                    f"{prefix}.attention.v_proj", heads)
    attn["out"] = _linear(sd, f"{prefix}.attention.out_proj")
    return {
        "attention": attn,
        "ln1": _layernorm(sd, f"{prefix}.layer_norm"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.feed_forward.intermediate_dense"),
            "fc2": _linear(sd, f"{prefix}.feed_forward.output_dense"),
        },
        "ln2": _layernorm(sd, f"{prefix}.final_layer_norm"),
    }


def convert_wav2vec2(model_or_sd: Any, spec: Wav2Vec2Spec,
                     prefix: str = "") -> Dict[str, Any]:
    """HF ``Wav2Vec2Model`` → ``Wav2Vec2Model`` params, in both
    feature-extractor norm modes. With ``do_stable_layer_norm`` the
    encoder's last LayerNorm is ``layers/final_ln``, else ``encoder/ln``; a
    checkpoint without ``masked_spec_embed`` gives zeros."""
    sd = state_dict_np(model_or_sd)
    p = prefix
    heads = spec.encoder.heads

    fe: Dict[str, Any] = {}
    for i in range(len(spec.conv_dims)):
        fe[f"conv_{i}"] = _conv1d(sd, f"{p}feature_extractor.conv_layers.{i}.conv")
        if spec.feat_extract_norm == "layer":
            fe[f"ln_{i}"] = _layernorm(
                sd, f"{p}feature_extractor.conv_layers.{i}.layer_norm")
    if spec.feat_extract_norm == "group":
        fe["group_norm"] = _layernorm(
            sd, f"{p}feature_extractor.conv_layers.0.layer_norm")

    layers: Dict[str, Any] = {
        f"layer_{i}": convert_wav2vec2_layer(sd, f"{p}encoder.layers.{i}", heads)
        for i in range(spec.encoder.layers)
    }
    encoder: Dict[str, Any] = {
        "pos_conv": {"conv": {
            "kernel": _pos_conv_kernel(sd, f"{p}encoder.pos_conv_embed.conv"),
            "bias": sd[f"{p}encoder.pos_conv_embed.conv.bias"],
        }},
        "layers": layers,
    }
    if spec.do_stable_layer_norm:
        layers["final_ln"] = _layernorm(sd, f"{p}encoder.layer_norm")
    else:
        encoder["ln"] = _layernorm(sd, f"{p}encoder.layer_norm")

    params: Dict[str, Any] = {
        "feature_extractor": fe,
        "feature_projection": {
            "ln": _layernorm(sd, f"{p}feature_projection.layer_norm"),
            "projection": _linear(sd, f"{p}feature_projection.projection"),
        },
        "encoder": encoder,
    }
    if f"{p}masked_spec_embed" in sd:
        params["masked_spec_embed"] = sd[f"{p}masked_spec_embed"]
    else:
        params["masked_spec_embed"] = np.zeros(
            (spec.encoder.hidden,), np.float32)
    return params


def convert_videomae_layer(sd: Mapping[str, np.ndarray], prefix: str,
                           heads: int) -> Dict[str, Any]:
    """One HF VideoMAE layer → the pre-LN ``EncoderBlock`` tree. VideoMAE
    learns q and v biases; the k bias is zero (``qkv_bias="qv"``)."""
    a = f"{prefix}.attention.attention"
    qw, kw, vw = sd[f"{a}.query.weight"].T, sd[f"{a}.key.weight"].T, \
        sd[f"{a}.value.weight"].T
    hidden_in, hidden_out = qw.shape
    head_dim = hidden_out // heads
    kernel = np.stack([qw, kw, vw], axis=1).reshape(hidden_in, 3, heads,
                                                    head_dim)
    zeros = np.zeros(hidden_out, qw.dtype)
    qb = sd.get(f"{a}.q_bias", zeros)
    vb = sd.get(f"{a}.v_bias", zeros)
    attn: Dict[str, Any] = {
        "qkv": {"kernel": kernel},
        "qkv_bias": np.stack([qb, zeros, vb], 0).reshape(3, heads, head_dim),
        "out": _linear(sd, f"{prefix}.attention.output.dense"),
    }
    return {
        "attention": attn,
        "ln1": _layernorm(sd, f"{prefix}.layernorm_before"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.intermediate.dense"),
            "fc2": _linear(sd, f"{prefix}.output.dense"),
        },
        "ln2": _layernorm(sd, f"{prefix}.layernorm_after"),
    }


def convert_videomae(model_or_sd: Any, spec: VideoMAESpec,
                     prefix: str = "") -> Dict[str, Any]:
    """HF ``VideoMAEModel`` → ``VideoMAEModel`` params. The Conv3d patch
    projection [hidden, C, t, p, p] becomes the ``TubeletEmbed`` matmul
    kernel [(t·p·p·C), hidden], patches in (t, h, w, c) order."""
    sd = state_dict_np(model_or_sd)
    p = prefix
    w = sd[f"{p}embeddings.patch_embeddings.projection.weight"]
    kernel = w.transpose(2, 3, 4, 1, 0).reshape(-1, w.shape[0])
    params: Dict[str, Any] = {
        "patch_embed": {"proj": {
            "kernel": kernel,
            "bias": sd[f"{p}embeddings.patch_embeddings.projection.bias"],
        }},
        "encoder": {
            f"layer_{i}": convert_videomae_layer(
                sd, f"{p}encoder.layer.{i}", spec.encoder.heads)
            for i in range(spec.encoder.layers)
        },
    }
    return params


def _conv2d(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """torch Conv2d [out, in, kh, kw] → flax [kh, kw, in, out]."""
    p = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _batchnorm(sd: Mapping[str, np.ndarray], prefix: str):
    """A BatchNorm → (its params, its running statistics)."""
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def convert_resnet50(model_or_sd: Any,
                     prefix: str = "") -> Dict[str, Any]:
    """HF ``ResNetModel`` / ``ResNetForImageClassification`` (the
    'microsoft/resnet-50' layout, torchvision's resnet50 v1.5 geometry) →
    ``ResNet50``'s ``{"params", "batch_stats"}``. A checkpoint without the
    ``classifier.1`` head gives a zero [2048, 1] ``fc``."""
    sd = state_dict_np(model_or_sd)
    p = prefix
    if f"{p}resnet.embedder.embedder.convolution.weight" in sd:
        p = f"{p}resnet."
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["conv1"] = _conv2d(sd, f"{p}embedder.embedder.convolution")
    params["bn1"], stats["bn1"] = _batchnorm(
        sd, f"{p}embedder.embedder.normalization")
    stage_sizes = (3, 4, 6, 3)
    for stage, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            tp = f"{p}encoder.stages.{stage}.layers.{b}"
            name = f"layer{stage + 1}_{b}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for i in (1, 2, 3):
                bp[f"conv{i}"] = _conv2d(sd, f"{tp}.layer.{i-1}.convolution")
                bp[f"bn{i}"], bs[f"bn{i}"] = _batchnorm(
                    sd, f"{tp}.layer.{i-1}.normalization")
            if f"{tp}.shortcut.convolution.weight" in sd:
                bp["down_conv"] = _conv2d(sd, f"{tp}.shortcut.convolution")
                bp["down_bn"], bs["down_bn"] = _batchnorm(
                    sd, f"{tp}.shortcut.normalization")
            params[name] = bp
            stats[name] = bs
    if "classifier.1.weight" in sd:
        params["fc"] = _linear(sd, "classifier.1")
    else:
        params["fc"] = {"kernel": np.zeros((2048, 1), np.float32),
                        "bias": np.zeros((1,), np.float32)}
    return {"params": params, "batch_stats": stats}


def convert_visualbert_pretraining(model_or_sd: Any, spec: Any) -> Dict[str, Any]:
    """HF ``VisualBertForPreTraining`` → ``VisualBertForPreTraining``
    params (the decoder is the word table's; its bias is ``decoder_bias``)."""
    sd = state_dict_np(model_or_sd)
    heads = spec.encoder.heads
    vb = "visual_bert."
    embeddings = {
        "word": {"embedding": sd[f"{vb}embeddings.word_embeddings.weight"]},
        "position": {
            "embedding": sd[f"{vb}embeddings.position_embeddings.weight"]},
        "token_type": {
            "embedding": sd[f"{vb}embeddings.token_type_embeddings.weight"]},
        "visual_token_type": {
            "embedding": sd[
                f"{vb}embeddings.visual_token_type_embeddings.weight"]},
        "visual_position": {
            "embedding": sd[
                f"{vb}embeddings.visual_position_embeddings.weight"]},
        "visual_projection": _linear(sd, f"{vb}embeddings.visual_projection"),
        "ln": _layernorm(sd, f"{vb}embeddings.LayerNorm"),
    }
    model = {
        "embeddings": embeddings,
        "encoder": {
            f"layer_{i}": convert_bert_layer(sd, f"{vb}encoder.layer.{i}",
                                             heads)
            for i in range(spec.encoder.layers)
        },
        "pooler": _linear(sd, f"{vb}pooler.dense"),
    }
    return {
        "visual_bert": model,
        "transform_dense": _linear(
            sd, "cls.predictions.transform.dense"),
        "transform_ln": _layernorm(
            sd, "cls.predictions.transform.LayerNorm"),
        "decoder_bias": sd["cls.predictions.bias"],
    }


def _conv3d(sd: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    """torch Conv3d [out, in, kt, kh, kw] → flax [kt, kh, kw, in, out]."""
    return {"kernel": sd[key].transpose(2, 3, 4, 1, 0)}


def convert_slow_r50(model_or_sd: Any,
                     stage_sizes: Sequence[int] = (3, 4, 6, 3)
                     ) -> Dict[str, Any]:
    """pytorchvideo's ``slow_r50`` (the reference's torch.hub video
    backbone) → ``SlowR50``'s backbone ``{"params", "batch_stats"}``.

    Keys: the stem ``blocks.0.{conv,norm}``; the stages
    ``blocks.{s}.res_blocks.{b}`` with ``branch2.{conv,norm}_{a,b,c}`` and
    the first block's ``branch1_{conv,norm}`` shortcut; the kinetics head
    ``blocks.5.proj`` is not mapped (the model's own ``proj`` and
    ``classifier`` replace it). Takes a plain state dict or one nested
    under ``model_state.``."""
    sd = state_dict_np(model_or_sd)
    if any(k.startswith("model_state.") for k in sd):
        sd = {k[len("model_state."):]: v for k, v in sd.items()
              if k.startswith("model_state.")}
    params: Dict[str, Any] = {"stem_conv": _conv3d(sd, "blocks.0.conv.weight")}
    stats: Dict[str, Any] = {}
    params["stem_bn"], stats["stem_bn"] = _batchnorm(sd, "blocks.0.norm")
    for s, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            pre = f"blocks.{s + 1}.res_blocks.{b}"
            name = f"layer{s + 1}_{b}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for our, theirs in (("conv1", "conv_a"), ("conv2", "conv_b"),
                                ("conv3", "conv_c")):
                bp[our] = _conv3d(sd, f"{pre}.branch2.{theirs}.weight")
            for our, theirs in (("bn1", "norm_a"), ("bn2", "norm_b"),
                                ("bn3", "norm_c")):
                bp[our], bs[our] = _batchnorm(sd, f"{pre}.branch2.{theirs}")
            if f"{pre}.branch1_conv.weight" in sd:
                bp["down_conv"] = _conv3d(sd, f"{pre}.branch1_conv.weight")
                bp["down_bn"], bs["down_bn"] = _batchnorm(
                    sd, f"{pre}.branch1_norm")
            params[name] = bp
            stats[name] = bs
    return {"params": params, "batch_stats": stats}
