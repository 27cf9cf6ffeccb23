"""The port's GAN models (`posecnn_torch/models/gan.py`) against the JAX
package's (`posecnn_tpu/models/gan.py`): the cases of tests/test_models.py
(the DCGAN and vgg16_gan shapes, DCGAN's running statistics) through the
port, each beside JAX's values on the same weights and inputs; `deconv_2`'s
bilinear path, which reads none of its weights in either package (ROADMAP
Queue 3 item 54); the strided SAME convolutions and the learned transposed
convolution of `models/layers.py`; the feature discriminator, the losses,
vgg16_gan's dropout with JAX's masks replayed; the weights' layouts across
`core/convert.py`; and the GAN golden.

Tolerances (float32): each output within 1e-5 of its largest magnitude;
DCGAN's train mode and vgg16_gan's label score at the golden's looser
limit (`tests/torch_parity.py:GAN_LOOSE_TOL`, and why); labels exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.models import gan as JG
from posecnn_tpu.models import layers as JL
from posecnn_torch.models import gan as G
from posecnn_torch.models import layers as L
from tests.torch_parity import GAN_LOOSE_TOL, check_gan_golden, gan_on_golden, goldens, load_npz, t

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def test_gan_shapes():
    """tests/test_models.py:test_gan_shapes: DCGAN at size 64 in eval mode,
    z = 0 and a zero image (B=2): the generator's (2, 64, 64, 3) image and
    the discriminator's (2, 1) logit, JAX's values."""
    p = G.init_dcgan_params_numpy(0, size=64)
    m = G.make_dcgan(p, "cpu")
    z, img = np.zeros((2, 100), np.float32), np.zeros((2, 64, 64, 3), np.float32)
    with torch.no_grad():
        g = G.dcgan_generator(m, t(z), t(img), train=False)
        d = G.dcgan_discriminator(m, torch.cat([t(img), g], dim=3), train=False)
    assert g.shape == (2, 64, 64, 3) and d.shape == (2, 1)
    jg = JG.dcgan_generator(_jax(p), jnp.asarray(z), jnp.asarray(img), train=False)
    jd = JG.dcgan_discriminator(_jax(p), jnp.concatenate([jnp.asarray(img), jg], axis=3), train=False)
    _close(g, jg, "generator")
    _close(d, jd, "discriminator")


def test_vgg16_gan_shapes():
    """tests/test_models.py:test_vgg16_gan_shapes: 3 classes, 4 units,
    zero 32x32 data and targets, float32: the patch discriminator's (1, 1,
    1, 2) maps for [fake, real], JAX's values."""
    C = 3
    p = G.init_vgg16_gan_params_numpy(0, C, num_units=4)
    m = G.make_vgg16_gan(C, p, "cpu")
    data, vt = np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 32, 32, 3 * C), np.float32)
    with torch.no_grad():
        out = G.vgg16_gan_forward(m, t(data), C, vertex_targets=t(vt), compute_dtype=torch.float32)
    assert out["prob"].shape == (1, 32, 32, C) and out["vertex_pred"].shape == (1, 32, 32, 3 * C)
    assert len(out["outputs_d"]) == 2 and out["outputs_d"][0].shape == (1, 1, 1, 2)
    ref = JG.vgg16_gan_forward(_jax(p), jnp.asarray(data), C, vertex_targets=jnp.asarray(vt),
                               compute_dtype=jnp.float32)
    for k in ("prob", "vertex_pred"):
        _close(out[k], ref[k], k)
    for i in range(2):
        _close(out["outputs_d"][i], ref["outputs_d"][i], f"outputs_d[{i}]")


def test_dcgan_running_stats_update_and_eval():
    """tests/test_models.py:test_dcgan_running_stats_update_and_eval: the
    train-mode statistics move off their init values and equal JAX's;
    merged into the model, eval mode runs finite and equals JAX's on its
    merged tree."""
    p = G.init_dcgan_params_numpy(0, size=32)
    m = G.make_dcgan(p, "cpu")
    z = np.random.RandomState(0).uniform(-1, 1, (1, 100)).astype(np.float32)
    img = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        out, stats = G.dcgan_generator(m, t(z), t(img), train=True, return_stats=True)
    jout, jstats = JG.dcgan_generator(_jax(p), jnp.asarray(z), jnp.asarray(img), train=True, return_stats=True)
    assert "bn1" in stats and float(stats["bn1"]["mean"].abs().sum()) > 0
    assert sorted(stats) == sorted(jstats)
    for name, st in stats.items():
        for leaf, v in st.items():
            _close(v, jstats[name][leaf], f"{name}/{leaf}")
    G.merge_bn_stats(m, stats)
    assert float(m.bn1.mean.detach().abs().sum()) > 0
    with torch.no_grad():
        ev = G.dcgan_generator(m, t(z), t(img), train=False)
    assert torch.isfinite(ev).all()
    _close(ev, JG.dcgan_generator(JG.merge_bn_stats(_jax(p), jstats), jnp.asarray(z), jnp.asarray(img), train=False),
           "eval after merge")


def test_deconv_2_weights_are_not_read():
    """ROADMAP Queue 3 item 54: `deconv_2` (4, 4, 512, 512) at stride 2
    takes JAX's bilinear path, so new weights there change neither
    package's generator; new weights in `deconv_3` (512 -> 256) change
    both, alike."""
    p = G.init_dcgan_params_numpy(3, size=32)
    z = np.random.RandomState(2).uniform(-1, 1, (2, 100)).astype(np.float32)
    img = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)

    def both(params):
        with torch.no_grad():
            got = G.dcgan_generator(G.make_dcgan(params, "cpu"), t(z), t(img), train=False).numpy()
        ref = np.asarray(JG.dcgan_generator(_jax(params), jnp.asarray(z), jnp.asarray(img), train=False))
        _close(got, ref, "generator")
        return got, ref

    base = both(p)
    for layer, moves in (("deconv_2", False), ("deconv_3", True)):
        q = {k: (dict(v) if isinstance(v, dict) else v) for k, v in p.items()}
        q[layer] = {"weights": (p[layer]["weights"] + 0.02).astype(np.float32)}
        got, ref = both(q)
        assert (not np.array_equal(got, base[0])) == moves and (not np.array_equal(ref, base[1])) == moves, layer


@pytest.mark.parametrize("k,stride,side", [(4, 2, 16), (4, 2, 15), (3, 2, 16), (3, 2, 15), (1, 1, 7)])
def test_strided_same_conv_matches_jax(k, stride, side):
    """`layers.conv2d_strided` against JAX's conv2d at stride 2 with TF SAME
    padding: a 4x4/2 convolution of an even side pads 1 and 1, a 3x3/2 one
    0 and 1 (odd sides as TF: the odd pixel after)."""
    rng = np.random.RandomState(k * 100 + side)
    x = rng.randn(2, side, side + 2, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    got = L.conv2d_strided(t(w.transpose(3, 2, 0, 1).copy()), t(b), t(x), stride, relu=True)
    ref = JL.conv2d({"weights": jnp.asarray(w), "biases": jnp.asarray(b)}, jnp.asarray(x), stride=stride)
    _close(got, ref, "conv")
    if (k, stride) == (4, 2) and side % 2 == 0:
        assert L.same_pads(side, 4, 2) == (1, 1)
    if (k, stride) == (3, 2) and side % 2 == 0:
        assert L.same_pads(side, 3, 2) == (0, 1)


@pytest.mark.parametrize("k,stride,ci,co", [(4, 2, 6, 4), (4, 2, 4, 4), (3, 2, 5, 3), (4, 1, 3, 5)])
def test_transposed_conv_matches_jax(k, stride, ci, co):
    """`layers.deconv_weights` against JAX's `layers.deconv` on a stored
    kernel: the learned transposed convolution (c_o != c_i or k > 2 x
    stride), or the bilinear path (c_o == c_i, k <= 2 x stride)."""
    rng = np.random.RandomState(ci * 10 + co)
    x = rng.randn(2, 5, 6, ci).astype(np.float32)
    w = rng.randn(k, k, co, ci).astype(np.float32)
    got = L.deconv_weights(t(w.transpose(3, 2, 0, 1).copy()), t(x), stride)
    _close(got, JL.deconv({"weights": jnp.asarray(w)}, jnp.asarray(x), stride=stride), "deconv")


def test_feature_discriminator_and_losses_match_jax():
    p = G.init_feature_discriminator_numpy(4, channels=16)
    feat = np.random.RandomState(4).randn(2, 9, 12, 16).astype(np.float32)
    with torch.no_grad():
        got = G.feature_discriminator(G.make_feature_discriminator(p, "cpu"), t(feat))
    assert got.shape == (2, 2)
    _close(got, JG.feature_discriminator(_jax(p), jnp.asarray(feat)), "feature discriminator")
    real, fake = np.float32([0.3, -1.2, 2.0]), np.float32([-0.4, 0.9, 0.1])
    for a, b, what in zip(G.gan_losses(t(real), t(fake)), JG.gan_losses(jnp.asarray(real), jnp.asarray(fake)),
                          ("d_loss", "g_loss")):
        _close(a, b, what, tol=1e-6)


def test_vgg16_gan_dropout_with_jax_masks():
    """vgg16_gan_forward at keep_prob 0.5 with JAX's dropout masks replayed
    (`engine.train.Draws`: each named draw is the jax.random.uniform of the
    key JAX's bernoulli reads), against JAX under that key."""
    from posecnn_torch.engine.train import Draws

    C, U = 3, 4
    p = G.init_vgg16_gan_params_numpy(1, C, num_units=U)
    rng = np.random.RandomState(5)
    data = (50.0 * rng.randn(1, 32, 32, 3)).astype(np.float32)
    vt = (0.1 * rng.randn(1, 32, 32, 3 * C)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    rg, rd1, rd2 = jax.random.split(key, 3)
    r1, r2 = jax.random.split(rg)

    def u(k, shape):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))

    # the heads' dropout at conv4_3's 4x4, the discriminator's at conv5's 2x2
    draws = {"dropout/gan_score": u(r1, (1, 4, 4, U)), "dropout/gan_vertex": u(r2, (1, 4, 4, 128))}
    for pass_name, rd in (("fake", rd1), ("real", rd2)):
        ks = jax.random.split(rd, 4)
        for i, name in enumerate(("conv5_1_d", "conv5_2_d", "conv5_3_d")):
            draws[f"dropout/gan_{pass_name}/{name}"] = u(ks[i], (1, 2, 2, 512))
    with torch.no_grad():
        out = G.vgg16_gan_forward(G.make_vgg16_gan(C, p, "cpu"), t(data), C, vertex_targets=t(vt), keep_prob=0.5,
                                  draws=Draws(replay=draws), compute_dtype=torch.float32)
    ref = JG.vgg16_gan_forward(_jax(p), jnp.asarray(data), C, vertex_targets=jnp.asarray(vt), keep_prob=0.5, rng=key,
                               compute_dtype=jnp.float32)
    _close(out["vertex_pred"], ref["vertex_pred"], "vertex_pred")
    _close(out["score"], ref["score"], "score", tol=GAN_LOOSE_TOL)
    for i in range(2):
        _close(out["outputs_d"][i], ref["outputs_d"][i], f"outputs_d[{i}]")


def test_gan_weights_cross_over():
    """The JAX trees go into the port's models and back whole: DCGAN's
    (its int `size` a model attribute, and the leaf written back), from a
    nested tree and from a flat npz layout; vgg16_gan's with its bilinear
    upscores written back from the formula; every leaf equal."""
    from posecnn_torch.core.convert import params_from_numpy, params_to_numpy

    dc = G.init_dcgan_params_numpy(2, size=64)
    m = G.make_dcgan(dc, "cpu")
    assert m.size == 64 and not any(isinstance(v, int) for v in m.state_dict().values())
    back = G.dcgan_params_to_numpy(m)
    assert back["size"] == 64 and sorted(back) == sorted(dc)
    flat = {"['size']": np.asarray(64)}
    for layer, leaves in dc.items():
        if isinstance(leaves, dict):
            for leaf, a in leaves.items():
                assert np.array_equal(back[layer][leaf], a), (layer, leaf)
                flat[f"['{layer}']['{leaf}']"] = a
    m2 = G.make_dcgan(flat, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(), m2.state_dict().values()))
    assert tuple(m.deconv_1.weight.shape) == (1024, 512, 4, 4)  # (c_i, c_o, k, k)
    with pytest.raises(ValueError, match="not layers"):  # only `size` is left out
        params_from_numpy({**dc, "stray": np.zeros(3, np.float32)})
    vg = G.init_vgg16_gan_params_numpy(2, 3, num_units=4)
    vback = params_to_numpy(G.make_vgg16_gan(3, vg, "cpu").state_dict())
    assert sorted(vback) == sorted(vg)
    for layer, leaves in vg.items():
        for leaf, a in leaves.items():
            assert np.array_equal(vback[layer][leaf], a), (layer, leaf)


def test_gan_golden_is_current():
    """The committed GAN golden equals JAX run again now."""
    Gd = goldens()
    g, ref = Gd.gan_golden(), load_npz(Gd.GAN_GOLDEN)
    assert sorted(g) == sorted(ref)
    for k in g:
        if np.asarray(g[k]).dtype.kind == "f":
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.array_equal(np.asarray(g[k]), ref[k]), k
    assert os.path.getsize(Gd.GAN_GOLDEN) < 200 << 10


def test_gan_matches_golden():
    """The shared check (chip_smoke.py reads the same limits)."""
    err = check_gan_golden(gan_on_golden("cpu"), load_npz(goldens().GAN_GOLDEN))
    assert err["feature_d"] <= 1e-5


def test_dcgan_eval_differs_from_train():
    """The golden's batch norms are off the identity: eval mode (stored
    statistics) and train mode (the batch's) give different images."""
    g = load_npz(goldens().GAN_GOLDEN)
    assert np.abs(g["dcgan/eval/gen"] - g["dcgan/train/gen"]).max() > 1e-2
