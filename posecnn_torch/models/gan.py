"""GAN variants: DCGAN image synthesis and adversarial feature alignment.

Port of `posecnn_tpu/models/gan.py`:

  * DCGAN (`DCGAN`, `dcgan_generator`, `dcgan_discriminator`): an
    encoder-decoder generator conditioned on a 100-d z and an image (five
    4x4/2 convolutions with batch norm and ReLU, z's fully connected map
    concatenated, five 4x4/2 transposed convolutions with batch norm and
    ReLU, a 1x1 convolution and tanh) and a discriminator over an image pair
    (five 4x4/2 convolutions, batch norm after the first, leaky ReLU, one
    logit). The convolutions pad as TensorFlow's SAME
    (`layers.conv2d_strided`), the transposed ones as
    tf.nn.conv2d_transpose (`layers.deconv_weights`): `deconv_2`, 512 -> 512
    channels at k 4 <= 2 x stride, takes JAX's bilinear path, which reads
    none of its weights (ROADMAP Queue 3 item 54).
  * Batch norm (`_bn`): in training the batch's mean and biased variance
    over (B, H, W), and new running statistics 0.9 x old + 0.1 x batch
    returned beside the output (`return_stats`); `merge_bn_stats` writes
    them into the model, as JAX folds them into its parameter tree. In eval
    the stored statistics. eps 1e-5. The statistics are parameters, as
    JAX keeps them in its tree.
  * `feature_discriminator`: vgg16_gan's domain discriminator over backbone
    features (two 3x3/2 convolutions with leaky ReLU, a spatial mean, two
    logits).
  * vgg16_gan (`VGG16GAN`, `vgg16_gan_forward`): the FCN generator (the VGG
    trunk, a label head and a vertex head, each a fused conv5/conv4 score
    with dropout, upsampled x8) and a VGG patch discriminator over
    concat(255 x vertex map, image), run on the predicted and on the target
    vertex map with one set of weights; per-patch 2-class log-softmax maps
    at stride 32. The trunk runs in `compute_dtype` (bf16: conv1_2 on the
    conv3x3 kernel, as `models/backbone.py`); the discriminator's
    convolutions are cuDNN's, as JAX's are XLA's. Dropout reads named
    draws (`engine.train.Draws`): "dropout/gan_score",
    "dropout/gan_vertex" and "dropout/gan_<pass>/<layer>" for the
    discriminator's conv5 layers (pass "fake" or "real").

Parameters carry JAX's names: `init_*_params_numpy` draw them in the JAX
layout from a numpy seed and `core/convert.py` moves them across (DCGAN's
int `size` leaf is the module's `size` attribute).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import Conv, VGGTrunk
from posecnn_torch.models.posecnn import Linear

_G_ENC = [("conv1", 3, 64), ("conv2", 64, 128), ("conv3", 128, 256), ("conv4", 256, 512), ("conv5", 512, 512)]
_G_DEC = [("deconv_1", 1024, 512), ("deconv_2", 512, 512), ("deconv_3", 512, 256), ("deconv_4", 256, 128),
          ("deconv_5", 128, 64)]
_D_ENC = [("conv1_d", 6, 64), ("conv2_d", 64, 128), ("conv3_d", 128, 256), ("conv4_d", 256, 512),
          ("conv5_d", 512, 512)]
Z_DIM = 100


class BatchNorm(nn.Module):
    """`_init_bn_train`'s leaves: scale, offset, and the running mean and
    variance."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((c,), device=device))
        self.offset = nn.Parameter(torch.zeros((c,), device=device))
        self.mean = nn.Parameter(torch.zeros((c,), device=device))
        self.variance = nn.Parameter(torch.ones((c,), device=device))


class Deconv(nn.Module):
    """A transposed convolution's kernel, (c_i, c_o, k, k) (JAX's (k, k, c_o,
    c_i)); no bias."""

    def __init__(self, c_i: int, c_o: int, k: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_i, c_o, k, k), device=device))


def _bn(bn: BatchNorm, x: torch.Tensor, train: bool, relu: bool = False, momentum: float = 0.9,
        eps: float = 1e-5) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`gan.py:_bn`: (output, the new running statistics)."""
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
        stats = {"mean": momentum * bn.mean + (1 - momentum) * mean,
                 "variance": momentum * bn.variance + (1 - momentum) * var}
    else:
        mean, var = bn.mean, bn.variance
        stats = {"mean": bn.mean, "variance": bn.variance}
    y = (x - mean) * torch.rsqrt(var + eps) * bn.scale + bn.offset
    return (torch.relu(y) if relu else y), stats


def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    return torch.maximum(x, leak * x)


class DCGAN(nn.Module):
    """The parameters of `init_dcgan_params` at image side `size` (a
    multiple of 32): generator and discriminator in one tree, as JAX's."""

    def __init__(self, size: int = 128, device=None):
        super().__init__()
        self.size = size
        s = size // 32
        self.fc_z = Linear(Z_DIM, s * s * 512, device=device)
        for name, ci, co in _G_ENC:
            self.add_module(name, Conv(ci, co, 4, device=device))
            self.add_module("bn" + name[-1], BatchNorm(co, device=device))
        for name, ci, co in _G_DEC:
            self.add_module(name, Deconv(ci, co, 4, device=device))
            self.add_module(f"bn{name[-1]}_deconv", BatchNorm(co, device=device))
        self.conv_output = Conv(64, 3, 1, device=device)
        for name, ci, co in _D_ENC:
            self.add_module(name, Conv(ci, co, 4, device=device))
            if name != "conv1_d":
                self.add_module(f"bn{name[4]}_d", BatchNorm(co, device=device))
        self.fc_d = Linear(512 * s * s, 1, device=device)


def _bn_numpy(c: int) -> Dict[str, np.ndarray]:
    return {"scale": np.ones((c,), np.float32), "offset": np.zeros((c,), np.float32),
            "mean": np.zeros((c,), np.float32), "variance": np.ones((c,), np.float32)}


def init_dcgan_params_numpy(seed: int, size: int = 128) -> Dict:
    """Random weights in the JAX layout with `init_dcgan_params`' shapes and
    rules (He sqrt(2/fan_in) truncated at 2 sigma, the transposed kernels
    0.02 truncated, zero biases, batch norms at identity), from numpy seed
    `seed`; the int leaf `size` as JAX's tree has it."""
    from posecnn_torch.core.convert import _trunc_normal, init_conv, init_fc

    rng = np.random.default_rng(seed)
    s = size // 32
    p: Dict = {"size": size, "fc_z": init_fc(rng, Z_DIM, s * s * 512)}
    for name, ci, co in _G_ENC:
        p[name] = init_conv(rng, 4, ci, co)
        p["bn" + name[-1]] = _bn_numpy(co)
    for name, ci, co in _G_DEC:
        p[name] = {"weights": _trunc_normal(rng, (4, 4, co, ci), 0.02)}
        p[f"bn{name[-1]}_deconv"] = _bn_numpy(co)
    p["conv_output"] = init_conv(rng, 1, 64, 3)
    for name, ci, co in _D_ENC:
        p[name] = init_conv(rng, 4, ci, co)
        if name != "conv1_d":
            p[f"bn{name[4]}_d"] = _bn_numpy(co)
    p["fc_d"] = init_fc(rng, 512 * s * s, 1)
    return p


def make_dcgan(params: Dict, device) -> DCGAN:
    """`DCGAN` on `device` holding JAX-layout `params` (nested, with its
    `size`, or flat npz key paths with `['size']`)."""
    from posecnn_torch.core.convert import params_from_numpy

    size = params.get("size", params.get("['size']"))
    model = DCGAN(int(np.asarray(size)), device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model


def dcgan_params_to_numpy(model: DCGAN) -> Dict:
    """The inverse of `make_dcgan`: the JAX tree, `size` included."""
    from posecnn_torch.core.convert import params_to_numpy

    return {"size": model.size, **params_to_numpy(model.state_dict())}


def dcgan_generator(model: DCGAN, z: torch.Tensor, image: torch.Tensor, train: bool = True,
                    return_stats: bool = False):
    """z (B, 100), image (B, size, size, 3) -> (B, size, size, 3) in (-1, 1);
    with `return_stats` also {bn name: new running statistics}, which a
    training step must merge back (`merge_bn_stats`)."""
    s = model.size // 32
    stats: Dict[str, Dict[str, torch.Tensor]] = {}
    h_z = L.fc(model.fc_z.weight, model.fc_z.bias, z, relu=False).reshape(-1, s, s, 512)
    h = image
    for name, _, _ in _G_ENC:
        c = getattr(model, name)
        h = L.conv2d_strided(c.weight, c.bias, h, 2, relu=False)
        h, stats["bn" + name[-1]] = _bn(getattr(model, "bn" + name[-1]), h, train, relu=True)
    h = torch.cat([h, h_z], dim=3)
    for name, _, _ in _G_DEC:
        h = L.deconv_weights(getattr(model, name).weight, h, 2)
        bn = f"bn{name[-1]}_deconv"
        h, stats[bn] = _bn(getattr(model, bn), h, train, relu=True)
    out = torch.tanh(L.conv2d(model.conv_output.weight, model.conv_output.bias, h, relu=False))
    return (out, stats) if return_stats else out


def dcgan_discriminator(model: DCGAN, image_pair: torch.Tensor, train: bool = True, return_stats: bool = False):
    """image_pair (B, size, size, 6), the condition and the candidate
    concatenated -> logits (B, 1); `return_stats` as `dcgan_generator`."""
    h = image_pair
    stats: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, _, _ in _D_ENC:
        c = getattr(model, name)
        h = L.conv2d_strided(c.weight, c.bias, h, 2, relu=False)
        if name != "conv1_d":
            bn = f"bn{name[4]}_d"
            h, stats[bn] = _bn(getattr(model, bn), h, train)
        h = lrelu(h)
    logit = L.fc(model.fc_d.weight, model.fc_d.bias, h.reshape(h.shape[0], -1), relu=False)
    return (logit, stats) if return_stats else logit


@torch.no_grad()
def merge_bn_stats(model: nn.Module, stats: Dict[str, Dict[str, torch.Tensor]]) -> nn.Module:
    """Write batch-norm running statistics (`return_stats`) into the model,
    in place (`gan.py:merge_bn_stats` returns the merged tree). Returns the
    model."""
    for name, s in stats.items():
        bn = getattr(model, name)
        for leaf, v in s.items():
            getattr(bn, leaf).copy_(v)
    return model


def gan_losses(d_real_logit: torch.Tensor, d_fake_logit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The non-saturating sigmoid losses: (discriminator's, generator's)."""
    d_loss = F.softplus(-d_real_logit).mean() + F.softplus(d_fake_logit).mean()
    g_loss = F.softplus(-d_fake_logit).mean()
    return d_loss, g_loss


class FeatureDiscriminator(nn.Module):
    """The parameters of `init_feature_discriminator`."""

    def __init__(self, channels: int = 512, device=None):
        super().__init__()
        self.conv1_g = Conv(channels, 256, 3, device=device)
        self.conv2_g = Conv(256, 128, 3, device=device)
        self.fc_g = Linear(128, 2, device=device)


def init_feature_discriminator_numpy(seed: int, channels: int = 512) -> Dict:
    """`init_feature_discriminator`'s shapes and He rule from numpy seed
    `seed`."""
    from posecnn_torch.core.convert import init_conv, init_fc

    rng = np.random.default_rng(seed)
    return {"conv1_g": init_conv(rng, 3, channels, 256), "conv2_g": init_conv(rng, 3, 256, 128),
            "fc_g": init_fc(rng, 128, 2)}


def make_feature_discriminator(params: Dict, device) -> FeatureDiscriminator:
    """`FeatureDiscriminator` on `device` holding JAX-layout `params`."""
    from posecnn_torch.core.convert import params_from_numpy

    model = FeatureDiscriminator(params["conv1_g"]["weights"].shape[2], device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model


def feature_discriminator(model: FeatureDiscriminator, feat: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, channels) -> domain logits (B, 2)."""
    h = lrelu(L.conv2d_strided(model.conv1_g.weight, model.conv1_g.bias, feat, 2, relu=False))
    h = lrelu(L.conv2d_strided(model.conv2_g.weight, model.conv2_g.bias, h, 2, relu=False))
    return L.fc(model.fc_g.weight, model.fc_g.bias, h.mean(dim=(1, 2)), relu=False)


# (name, c_o, pool after, dropout after) of the patch discriminator
_VGG_GAN_D_DEFS = [
    ("conv1_1_d", 64, False, False),
    ("conv1_2_d", 64, True, False),
    ("conv2_1_d", 128, False, False),
    ("conv2_2_d", 128, True, False),
    ("conv3_1_d", 256, False, False),
    ("conv3_2_d", 256, False, False),
    ("conv3_3_d", 256, True, False),
    ("conv4_1_d", 512, False, False),
    ("conv4_2_d", 512, False, False),
    ("conv4_3_d", 512, True, False),
    ("conv5_1_d", 512, False, True),
    ("conv5_2_d", 512, False, True),
    ("conv5_3_d", 512, True, True),
]


class VGG16GAN(nn.Module):
    """The parameters of `init_vgg16_gan_params`: the generator's trunk and
    heads and the patch discriminator. The `upscore*` filters are fixed
    bilinear ones, not parameters."""

    def __init__(self, num_classes: int, num_units: int = 64, device=None):
        super().__init__()
        C, U = num_classes, num_units
        self.num_classes, self.num_units = C, U
        self.trunk = VGGTrunk(1.0, device=device)
        self.score_conv5 = Conv(512, U, 1, device=device)
        self.score_conv4 = Conv(512, U, 1, device=device)
        self.score = Conv(U, C, 1, device=device)
        self.score_conv5_vertex = Conv(512, 128, 1, device=device)
        self.score_conv4_vertex = Conv(512, 128, 1, device=device)
        self.vertex_pred = Conv(128, 3 * C, 1, device=device)
        c_i = 3 * C + 3
        for name, c_o, _, _ in _VGG_GAN_D_DEFS:
            self.add_module(name, Conv(c_i, c_o, 3, device=device))
            c_i = c_o
        self.embed_d = Conv(512, U, 3, device=device)
        self.score_d = Conv(U, 2, 1, device=device)


def init_vgg16_gan_params_numpy(seed: int, num_classes: int, num_units: int = 64) -> Dict:
    """Random weights in the JAX layout with `init_vgg16_gan_params`' shapes
    and rules (He sqrt(2/fan_in) truncated at 2 sigma, `score` 0.01 and
    `vertex_pred` 0.001, zero biases, bilinear upscores), from numpy seed
    `seed`."""
    from posecnn_torch.core.convert import init_conv
    from posecnn_torch.models.backbone import trunk_shapes

    rng = np.random.default_rng(seed)
    C, U = num_classes, num_units
    p: Dict = {name: init_conv(rng, 3, ci, co) for name, ci, co, _ in trunk_shapes()}
    p["score_conv5"] = init_conv(rng, 1, 512, U)
    p["upscore_conv5"] = {"weights": L.make_deconv_filter(4, U)}
    p["score_conv4"] = init_conv(rng, 1, 512, U)
    p["upscore"] = {"weights": L.make_deconv_filter(16, U)}
    p["score"] = init_conv(rng, 1, U, C, stddev=0.01)
    p["score_conv5_vertex"] = init_conv(rng, 1, 512, 128)
    p["upscore_conv5_vertex"] = {"weights": L.make_deconv_filter(4, 128)}
    p["score_conv4_vertex"] = init_conv(rng, 1, 512, 128)
    p["upscore_vertex"] = {"weights": L.make_deconv_filter(16, 128)}
    p["vertex_pred"] = init_conv(rng, 1, 128, 3 * C, stddev=0.001)
    c_i = 3 * C + 3
    for name, c_o, _, _ in _VGG_GAN_D_DEFS:
        p[name] = init_conv(rng, 3, c_i, c_o)
        c_i = c_o
    p["embed_d"] = init_conv(rng, 3, 512, U)
    p["score_d"] = init_conv(rng, 1, U, 2, stddev=0.01)
    return p


def make_vgg16_gan(num_classes: int, params: Dict, device) -> VGG16GAN:
    """`VGG16GAN` on `device` holding JAX-layout `params` (nested or flat);
    the units are read from `score_conv5`'s shape."""
    from posecnn_torch.core.convert import params_from_numpy

    sd = params_from_numpy(params, device)
    model = VGG16GAN(num_classes, sd["score_conv5.weight"].shape[0], device=device)
    model.load_state_dict(sd, strict=True)
    return model


def _dropout(x: torch.Tensor, keep: float, draws, name: str) -> torch.Tensor:
    if keep >= 1.0:
        return x
    return L.dropout(x, keep, uniform=draws.uniform(name, x.shape, x.device))


def vgg16_gan_generator(model: VGG16GAN, data: torch.Tensor, num_classes: int, keep_prob: float = 1.0, draws=None,
                        compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """data (B, H, W, 3) mean-subtracted BGR, H and W multiples of 32 ->
    score, prob (log-softmax), prob_normalized, label_2d (the score's
    argmax) and vertex_pred (B, H, W, 3C)."""
    dt = compute_dtype
    m = model
    net = m.trunk(data, compute_dtype=dt)
    sc5 = L.conv2d(m.score_conv5.weight, m.score_conv5.bias, net["conv5_3"], relu=True, compute_dtype=dt)
    sc4 = L.conv2d(m.score_conv4.weight, m.score_conv4.bias, net["conv4_3"], relu=True, compute_dtype=dt)
    add_score = _dropout(sc4 + L.deconv(sc5, 4, 2), keep_prob, draws, "dropout/gan_score")
    score = L.conv1x1_upsample(m.score.weight, m.score.bias, add_score, 16, 8, relu=True, compute_dtype=dt)
    sc5v = L.conv2d(m.score_conv5_vertex.weight, m.score_conv5_vertex.bias, net["conv5_3"], relu=False,
                    compute_dtype=dt)
    sc4v = L.conv2d(m.score_conv4_vertex.weight, m.score_conv4_vertex.bias, net["conv4_3"], relu=False,
                    compute_dtype=dt)
    addv = _dropout(sc4v + L.deconv(sc5v, 4, 2), keep_prob, draws, "dropout/gan_vertex")
    vertex_pred = L.conv1x1_upsample(m.vertex_pred.weight, m.vertex_pred.bias, addv, 16, 8, relu=False,
                                     compute_dtype=dt)
    return {"score": score, "prob": L.log_softmax_hd(score), "prob_normalized": L.softmax_hd(score),
            "label_2d": L.argmax_2d(score), "vertex_pred": vertex_pred}


def vgg16_gan_discriminator(model: VGG16GAN, vertex_map: torch.Tensor, data: torch.Tensor, keep_prob: float = 1.0,
                            draws=None, compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                            pass_name: str = "fake") -> torch.Tensor:
    """Per-patch real/fake log-probabilities (B, H/32, W/32, 2) over
    concat(255 x vertex_map, data); the dropout draws of this pass are
    named "dropout/gan_<pass_name>/<layer>"."""
    dt = compute_dtype
    h = torch.cat([255.0 * vertex_map, data], dim=-1)
    for name, _, pool_after, dropout_after in _VGG_GAN_D_DEFS:
        c = getattr(model, name)
        h = L.conv2d(c.weight, c.bias, h, relu=True, compute_dtype=dt)
        if dropout_after:
            h = _dropout(h, keep_prob, draws, f"dropout/gan_{pass_name}/{name}")
        if pool_after:
            h = L.max_pool(h, 2, 2)
    h = L.conv2d(model.embed_d.weight, model.embed_d.bias, h, relu=True, compute_dtype=dt)
    score_d = L.conv2d(model.score_d.weight, model.score_d.bias, h, relu=True, compute_dtype=dt)
    return L.log_softmax_hd(score_d)


def vgg16_gan_forward(model: VGG16GAN, data: torch.Tensor, num_classes: int, vertex_targets=None,
                      keep_prob: float = 1.0, draws=None,
                      compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The generator, then the discriminator on its vertex map and (given
    `vertex_targets`) on the targets: `outputs_d` = [fake, real]."""
    out = vgg16_gan_generator(model, data, num_classes, keep_prob, draws, compute_dtype)
    outputs_d = [vgg16_gan_discriminator(model, out["vertex_pred"], data, keep_prob, draws, compute_dtype, "fake")]
    if vertex_targets is not None:
        outputs_d.append(vgg16_gan_discriminator(model, vertex_targets, data, keep_prob, draws, compute_dtype,
                                                 "real"))
    out["outputs_d"] = outputs_d
    return out
