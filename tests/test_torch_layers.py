"""Layer primitives of the port against `posecnn_tpu/models/layers.py` and
`backbone.py`, on the same numpy inputs and weights.

Tolerances: float32 paths 1e-5 relative (atol 1e-5 x the output's scale).
bf16 paths are held to bf16 rounding: both frameworks accumulate in f32 and
round to bf16, so an output may differ by the rounding of one or two bf16
ulps (2**-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.models import backbone as JB
from posecnn_tpu.models import layers as JL
from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import VGGTrunk
from posecnn_torch.core.convert import params_from_numpy
from tests.torch_parity import t

torch.set_num_threads(1)

BF16_RTOL = 2.0 ** -7


def _close(got, ref, rtol=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _conv_params(rng, k, ci, co):
    return {
        "weights": (rng.randn(k, k, ci, co) * np.sqrt(2.0 / (k * k * ci))).astype(np.float32),
        "biases": (rng.randn(co) * 0.1).astype(np.float32),
    }


def _oihw(w):
    return t(w.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("k,dtype", [(3, "f32"), (1, "f32"), (3, "bf16")])
@pytest.mark.parametrize("relu", [True, False])
def test_conv2d_matches_jax(k, dtype, relu):
    rng = np.random.RandomState(0)
    p = _conv_params(rng, k, 6, 10)
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = JL.conv2d({k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x), relu=relu, compute_dtype=jdt)
    got = L.conv2d(_oihw(p["weights"]), t(p["biases"]), t(x), relu=relu, compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _close(got, ref, 1e-5 if dtype == "f32" else BF16_RTOL)


def test_conv1_2_bf16_branch_matches_jax():
    """conv3x3_manual_bwd's forward: bf16 conv, bias added in bf16, bf16 out."""
    rng = np.random.RandomState(1)
    p = _conv_params(rng, 3, 64, 64)
    x = np.maximum(rng.randn(1, 128, 12, 64), 0).astype(np.float32)
    ref = JL.conv3x3_manual_bwd({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.conv3x3_bf16_bias_relu(_oihw(p["weights"]), t(p["biases"]), t(x))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(ref.astype(jnp.float32)), BF16_RTOL)


def test_conv1_2_below_128_rows_matches_jax_conv2d():
    """Below 128 rows the trunk's conv1_2 is JAX's plain bf16 conv2d (f32
    bias, f32 out); the port runs its convolution on the conv3x3 path
    (`conv3x3_bf16_conv2d`). Forward and backward against jax.vjp of
    conv2d: the output, dx and dw within bf16 rounding, db within f32."""
    import jax

    rng = np.random.RandomState(4)
    p = _conv_params(rng, 3, 64, 64)
    x = np.maximum(rng.randn(2, 24, 20, 64), 0).astype(np.float32)
    g = rng.randn(2, 24, 20, 64).astype(np.float32)
    f = lambda x_, w_, b_: JL.conv2d({"weights": w_, "biases": b_}, x_, relu=True,  # noqa: E731
                                     compute_dtype=jnp.bfloat16)
    ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(p["weights"]), jnp.asarray(p["biases"]))
    rdx, rdw, rdb = vjp(jnp.asarray(g))
    xt, wt, bt = t(x).requires_grad_(True), _oihw(p["weights"]).requires_grad_(True), t(p["biases"]).requires_grad_(True)
    got = L.conv3x3_bf16_conv2d(wt, bt, xt)
    got.backward(t(g))
    assert got.dtype == torch.float32 and xt.grad.dtype == torch.float32
    _close(got.detach(), ref, BF16_RTOL)
    _close(xt.grad, rdx, BF16_RTOL)
    _close(wt.grad.permute(2, 3, 1, 0), rdw, BF16_RTOL)
    _close(bt.grad, rdb, 1e-5)
    # the same as the port's cuDNN/torch bf16 conv2d
    _close(got.detach(), L.conv2d(wt.detach(), bt.detach(), t(x), relu=True, compute_dtype=torch.bfloat16), BF16_RTOL)


def test_trunk_below_128_rows_matches_jax_bf16_full_width():
    """The VGG trunk in bf16 at full width on a 96x32 frame (the toy
    dataset's 96 rows): conv1_2 on the conv3x3 path with conv2d's
    numerics."""
    import jax

    params = JB.init_vgg_trunk(jax.random.PRNGKey(1))
    x = np.random.RandomState(5).uniform(-120, 130, (1, 96, 32, 3)).astype(np.float32)
    ref = JB.vgg_trunk(params, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    trunk = VGGTrunk()
    sd = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    trunk.load_state_dict({k[len("trunk."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = trunk(t(x), compute_dtype=torch.bfloat16)
    assert got["conv1_2"].dtype == torch.float32 and ref["conv1_2"].dtype == jnp.float32
    _close(got["conv1_2"], ref["conv1_2"], BF16_RTOL)
    for name in ("conv4_3", "conv5_3"):
        _close(got[name], ref[name], 5e-2)


def test_trunk_matches_jax_bf16_full_width():
    """VGG trunk in bf16 at full width, H >= 128 so the conv1_2 branch runs."""
    import jax

    params = JB.init_vgg_trunk(jax.random.PRNGKey(0))
    x = np.random.RandomState(2).uniform(-120, 130, (1, 128, 16, 3)).astype(np.float32)
    ref = JB.vgg_trunk(params, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    trunk = VGGTrunk()
    sd = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    trunk.load_state_dict({k[len("trunk."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = trunk(t(x), compute_dtype=torch.bfloat16)
    assert got["conv1_2"].dtype == torch.bfloat16
    _close(got["conv1_1"], ref["conv1_1"], BF16_RTOL)
    _close(got["conv1_2"].float(), np.asarray(ref["conv1_2"].astype(jnp.float32)), BF16_RTOL)
    # 13 layers of bf16 rounding compound: the deep maps are held to 5% of scale
    for name in ("conv4_3", "conv5_3"):
        assert got[name].shape == ref[name].shape
        _close(got[name], ref[name], 5e-2)


@pytest.mark.parametrize("k,s,h,w,c", [(4, 2, 5, 7, 6), (16, 8, 6, 5, 4)], ids=["k4s2", "k16s8"])
def test_deconv_matches_jax(k, s, h, w, c):
    x = np.random.RandomState(3).randn(2, h, w, c).astype(np.float32)
    ref = JL.deconv(JL.init_deconv(k, c), jnp.asarray(x), stride=s)
    got = L.deconv(t(x), k, s)
    assert got.shape == ref.shape == (2, h * s, w * s, c)
    _close(got, ref)


@pytest.mark.parametrize("relu", [True, False])
def test_conv1x1_upsample_matches_jax(relu):
    rng = np.random.RandomState(4)
    p = _conv_params(rng, 1, 8, 5)
    x = rng.randn(1, 6, 7, 8).astype(np.float32)
    ref = JL.conv1x1_upsample(
        {k: jnp.asarray(v) for k, v in p.items()}, JL.init_deconv(16, 5), jnp.asarray(x),
        stride=8, relu=relu, compute_dtype=jnp.float32,
    )
    got = L.conv1x1_upsample(_oihw(p["weights"]), t(p["biases"]), t(x), 16, 8, relu=relu, compute_dtype=torch.float32)
    _close(got, ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fc_flattens_nhwc(dtype):
    """fc6 reads a (R,7,7,C) pool in HWC flatten order."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 7, 4).astype(np.float32)
    w = (rng.randn(7 * 7 * 4, 16) * 0.1).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = JL.fc({"weights": jnp.asarray(w), "biases": jnp.asarray(b)}, jnp.asarray(x), relu=True, compute_dtype=jdt)
    got = L.fc(t(w.T), t(b), t(x), relu=True, compute_dtype=tdt)
    _close(got, ref, 1e-5 if dtype == "f32" else BF16_RTOL)


def test_softmaxes_argmax_l2_normalize():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 6, 4).astype(np.float32) * 3
    x[0, 0, 0] = [1.0, 2.0, 2.0, 0.5]  # a tie: the first maximum wins
    x[1, 2, 3] = [0.0, 0.0, 0.0, 0.0]
    _close(L.softmax_hd(t(x)), JL.softmax_hd(jnp.asarray(x)))
    _close(L.log_softmax_hd(t(x)), JL.log_softmax_hd(jnp.asarray(x)))
    got = L.argmax_2d(t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JL.argmax_2d(jnp.asarray(x))))
    assert got[0, 0, 0] == 1 and got[1, 2, 3] == 0
    q = rng.randn(4, 16).astype(np.float32)
    q[2] = 0.0  # all-zero row: eps keeps it finite
    _close(L.l2_normalize(t(q), dim=1), JL.l2_normalize(jnp.asarray(q), axis=1))


@pytest.mark.parametrize("h,w", [(8, 12), (7, 9)], ids=["even", "odd"])
def test_max_pool_matches_jax(h, w):
    x = np.random.RandomState(7).randn(2, h, w, 3).astype(np.float32)
    ref = JL.max_pool(jnp.asarray(x), 2, 2)
    got = L.max_pool(t(x), 2, 2)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
