"""The fused 3x3 conv of the port (`posecnn_torch/ops/conv3x3.py` and the
trunk's conv1_2 branch `models/layers.py:conv3x3_bf16_bias_relu`) against
`posecnn_tpu/ops/pallas/conv3x3.py` (the Pallas kernel in interpret mode)
and `posecnn_tpu/models/layers.py:conv3x3_manual_bwd`, on the same numpy
inputs. On the CPU the port runs the kernel's plain version.

Tolerances: bf16 outputs (y, dx) within 1 bf16 ulp (`bf16_ulp_excess`: the
same f32 sum taken in another order, then one rounding to bf16); dw and db
are f32 sums of exact products of bf16 values, held to 1e-5 of their
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.models import layers as JL
from posecnn_tpu.ops.pallas import conv3x3 as JC
from posecnn_torch.models import layers as L
from posecnn_torch.models.backbone import VGGTrunk
from posecnn_torch.ops import conv3x3 as C
from tests.torch_parity import bf16_ulp_excess, t

torch.set_num_threads(1)


def _inputs(seed, B=1, H=16, W=24, cin=64, cout=64):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(B, H, W, cin), 0).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, cout).astype(np.float32)
    return x, w, b, g


def _bf16(a):
    """numpy f32 -> the bf16-rounded values, as f32 (what both sides see)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _oihw(w):
    return t(w.transpose(3, 2, 0, 1))


def _close_f32(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("relu", [True, False])
def test_plain_conv_matches_pallas_interpret(relu):
    """conv3x3_bias_relu: value and dx, dw, db against the Pallas kernel's
    custom_vjp run in interpret mode."""
    x, w, b, g = _inputs(0)
    xb = _bf16(x)
    fwd = lambda x_, w_, b_: JC.conv3x3_bias_relu(x_, w_, b_, relu, True)
    ref, vjp = jax.vjp(fwd, jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = vjp(jnp.asarray(g).astype(jnp.bfloat16))

    xt = t(xb).to(torch.bfloat16).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    bt = t(b).requires_grad_(True)
    y = C.conv3x3_bias_relu(xt, wt, bt, relu)
    y.backward(t(g).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert bf16_ulp_excess(y, t(np.asarray(ref.astype(jnp.float32)))) <= 1.0
    assert bf16_ulp_excess(xt.grad, t(np.asarray(rdx.astype(jnp.float32)))) <= 1.0
    _close_f32(wt.grad.permute(2, 3, 1, 0), rdw)
    _close_f32(bt.grad, rdb)


def test_conv1_2_branch_matches_manual_bwd():
    """The trunk's conv1_2 function (conv body by the conv3x3 path, bias in
    bf16, ReLU) against conv3x3_manual_bwd: value, and dx (in the caller's
    f32), dw, db."""
    x, w, b, g = _inputs(1, B=2, H=8, W=20)
    p = {"weights": jnp.asarray(w), "biases": jnp.asarray(b)}
    ref, vjp = jax.vjp(lambda x_, p_: JL.conv3x3_manual_bwd(p_, x_), jnp.asarray(x), p)
    rdx, rp = vjp(jnp.asarray(g).astype(jnp.bfloat16))

    xt = t(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    bt = t(b).requires_grad_(True)
    y = L.conv3x3_bf16_bias_relu(wt, bt, xt)
    y.backward(t(g).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.float32
    # the trunk epilogue is, bit for bit, the conv rounded to bf16 with zero
    # bias, then the bf16 bias added in bf16, then ReLU
    xb, wb = t(x).to(torch.bfloat16), _oihw(w).permute(2, 3, 1, 0).to(torch.bfloat16)
    two_step = torch.relu(C.conv3x3_plain(xb, wb, torch.zeros(64), False) + t(b).to(torch.bfloat16))
    assert torch.equal(C.conv3x3_plain(xb, wb, t(b), True, bf16_bias=True), two_step)
    assert torch.equal(y, two_step)
    # the bias is added in bf16 after the conv's own rounding: a second
    # rounding, so allow one more ulp than the conv alone
    assert bf16_ulp_excess(y, t(np.asarray(ref.astype(jnp.float32)))) <= 2.0
    assert bf16_ulp_excess(xt.grad, t(np.asarray(rdx))) <= 1.0
    _close_f32(wt.grad.permute(2, 3, 1, 0), rp["weights"])
    _close_f32(bt.grad, rp["biases"])


def test_dgrad_is_the_flipped_transposed_conv():
    """dx of a SAME 3x3 conv equals the same conv of the cotangent with
    flipped, transposed weights (f32, against autograd of conv2d)."""
    x, w, _, g = _inputs(2, cin=32)
    xt = t(_bf16(x)).requires_grad_(True)
    wb = t(_bf16(w))
    y = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2), wb.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    gb = t(_bf16(g))
    y.backward(gb)
    zeros = torch.zeros(32)
    dx = C.conv3x3_plain(gb.to(torch.bfloat16), C.flip_transpose(wb.to(torch.bfloat16)), zeros, False)
    assert bf16_ulp_excess(dx, xt.grad.to(torch.bfloat16)) <= 1.0


def test_wrapper_checks_and_counts_only_kernel_launches():
    x, w, b, _ = _inputs(3, cin=16)
    xb, wb, bt = t(x).to(torch.bfloat16), t(w).to(torch.bfloat16), t(b)
    before = C.CONV3X3_LAUNCHES
    y = C.conv3x3_raw(xb, wb, bt, True)
    assert y.shape == (1, 16, 24, 64) and C.CONV3X3_LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(TypeError):
        C.conv3x3_raw(xb.float(), wb, bt, True)
    with pytest.raises(ValueError):
        C.conv3x3_raw(xb, wb[:, :, :8], bt, True)
    with pytest.raises(ValueError):
        C.conv3x3_raw(xb, wb, bt[:32], True)
    with pytest.raises(ValueError):
        C.conv3x3_raw(xb, wb.to("meta"), bt, True)


def test_trunk_conv1_2_goes_through_the_conv3x3_path(monkeypatch):
    """In bf16 at H >= 128 the trunk's conv1_2 (and its dgrad) runs the
    conv3x3 function; no other layer does."""
    calls = []
    plain = C.conv3x3_plain

    def spy(x, w, b, relu, bf16_bias=False):
        calls.append(tuple(x.shape))
        return plain(x, w, b, relu, bf16_bias)

    monkeypatch.setattr(C, "conv3x3_plain", spy)
    trunk = VGGTrunk()  # full width: the branch is for the 64-channel layer
    for p in trunk.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = t(np.random.RandomState(4).uniform(-100, 100, (1, 128, 16, 3)).astype(np.float32))
    out = trunk(x, compute_dtype=torch.bfloat16)
    assert calls == [(1, 128, 16, 64)] and out["conv1_2"].dtype == torch.bfloat16
    out["conv5_3"].float().sum().backward()
    assert calls == [(1, 128, 16, 64)] * 2  # forward, then dgrad
    assert trunk.conv1_1.weight.grad is not None


def _unswizzled(wp: np.ndarray) -> np.ndarray:
    """The packed image (Cout/64, 9, Cin/64, 64, 64) with each row's 16-byte
    chunks put back in order: slot chunk c of row n holds chunk c ^ (n % 8)."""
    n = np.arange(64)[:, None]
    src_chunk = np.arange(8)[None, :] ^ (n % 8)  # (64, 8): the chunk stored at each slot
    blocks = wp.reshape(wp.shape[:4] + (8, 8))
    out = np.empty_like(blocks)
    out[..., n, src_chunk, :] = blocks[..., n, np.arange(8)[None, :], :]
    return out.reshape(wp.shape)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_pack_weights_round_trips_to_hwio(cin, cout):
    """The kernel's weight image: block (co, tap, kb) holds w[tap][kb*64 + k][co*64 + n]
    at row n, input channel k, behind the 128-byte swizzle; every weight once."""
    w = t(np.random.RandomState(cin + cout).randn(3, 3, cin, cout).astype(np.float32)).to(torch.bfloat16)
    wp = C.pack_weights(w)
    assert wp.shape == (cout // 64, 9, cin // 64, 64, 64) and wp.dtype == torch.bfloat16 and wp.is_contiguous()
    bt = _unswizzled(wp.float().numpy())  # (co, tap, kb, n, k)
    hwio = bt.transpose(1, 2, 4, 0, 3).reshape(9, cin, cout).reshape(3, 3, cin, cout)
    np.testing.assert_array_equal(hwio, w.float().numpy())


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 64)])
def test_pack_weights_dgrad_is_flip_transpose(cin, cout):
    """The dgrad image made in one gather equals the image of
    flip_transpose(w); the gather reads the weights' strides (an OIHW
    parameter's HWIO view)."""
    w_oihw = t(np.random.RandomState(7).randn(cout, cin, 3, 3).astype(np.float32))
    w = C.oihw_to_hwio(w_oihw).to(torch.bfloat16)
    assert not w.is_contiguous()
    assert torch.equal(C.pack_weights(w, dgrad=True), C.pack_weights(C.flip_transpose(w)))
    assert torch.equal(C.pack_weights(w), C.pack_weights(w.contiguous()))


def test_dgrad_on_the_cpu_is_the_plain_flipped_conv():
    x, w, _, g = _inputs(5, B=2, H=6, W=10)
    wb, gb = t(w).to(torch.bfloat16), t(g).to(torch.bfloat16)
    before = C.CONV3X3_LAUNCHES
    dx = C.conv3x3_dgrad(gb, wb)
    assert C.CONV3X3_LAUNCHES == before and dx.shape == (2, 6, 10, 64)
    assert torch.equal(dx, C.conv3x3_plain(gb, C.flip_transpose(wb), torch.zeros(64), False))
    with pytest.raises(ValueError):
        C.conv3x3_dgrad(gb[..., :32], wb)


@pytest.mark.parametrize("cin,cout", [(48, 64), (64, 96), (16, 64), (256, 64)])
def test_kernel_takes_only_64_or_128_channels(cin, cout):
    with pytest.raises(ValueError):
        C._kernel_channels(cin, cout)
