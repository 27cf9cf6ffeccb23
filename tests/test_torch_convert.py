"""Weight conversion: JAX `init_posecnn_params` -> numpy -> the port, the
checkpoint npz layout both ways, and the port's own seeded init."""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core.checkpoint import _flatten_state, save_checkpoint
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_tpu.models.posecnn import init_posecnn_params
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core.convert import init_params_numpy, load_params_npz, make_model, params_from_numpy
from posecnn_torch.models.layers import make_deconv_filter
from tests.torch_parity import ROOT

torch.set_num_threads(1)

SMALL = dict(num_classes=4, num_units=8, is_train=False, fc_dim=64, trunk_scale=0.125)


def _jax_params():
    cfg = JaxCfg(compute_dtype=jnp.float32, **SMALL)
    return jax.tree_util.tree_map(np.asarray, init_posecnn_params(jax.random.PRNGKey(0), cfg))


def _expected(params, sd):
    """Every converted tensor equals the JAX array in the port's layout."""
    for name, leaves in params.items():
        if name.startswith("upscore"):
            assert not any(k.startswith(name + ".") for k in sd)
            continue
        key = f"trunk.{name}" if name.startswith("conv") else name
        w = leaves["weights"]
        w = w.T if name.startswith("fc") else w.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(sd[key + ".weight"].numpy(), w)
        np.testing.assert_array_equal(sd[key + ".bias"].numpy(), leaves["biases"])


def test_params_from_jax_init():
    params = _jax_params()
    sd = params_from_numpy(params)
    _expected(params, sd)
    model = make_model(PoseCNNConfig(compute_dtype=torch.float32, **SMALL), params, "cpu")
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("layout", ["train_state", "params_only"])
def test_npz_round_trip(tmp_path, layout):
    params = _jax_params()
    if layout == "train_state":
        opt_state = jax.tree_util.tree_map(np.zeros_like, params)
        path = save_checkpoint(str(tmp_path), (params, opt_state, np.int32(7)), 7, fmt="npz")
    else:
        path = str(tmp_path / "export.npz")
        np.savez(path, **_flatten_state(params))
    _expected(params, load_params_npz(path))


@pytest.mark.parametrize("bad", ["filter", "unknown"])
def test_converter_rejects(bad):
    params = _jax_params()
    if bad == "filter":
        params["upscore"] = {"weights": params["upscore"]["weights"] * 1.5}
    else:
        # a layer no network of either package has (fc9, used here before,
        # is now the domain head's; fc_d, after it, the DCGAN
        # discriminator's)
        params["fc10"] = {"weights": np.zeros((4, 2), np.float32), "biases": np.zeros(2, np.float32)}
    with pytest.raises(ValueError):
        params_from_numpy(params)


def test_init_params_numpy_matches_jax_init_rules():
    params = init_params_numpy(0, PoseCNNConfig(**SMALL))
    ref = _jax_params()
    assert set(params) == set(ref)
    for name, leaves in ref.items():
        for leaf, arr in leaves.items():
            assert params[name][leaf].shape == arr.shape and params[name][leaf].dtype == np.float32
    for name in ("score", "vertex_pred", "fc8"):
        assert not params[name]["biases"].any()
    np.testing.assert_array_equal(params["upscore"]["weights"], make_deconv_filter(16, 8))
    # truncated at 2 sigma: a 2-sigma-truncated normal has std 0.8796 sigma
    for name, sigma in (("fc6", math.sqrt(2.0 / (7 * 7 * 64))), ("fc7", math.sqrt(2.0 / 64)), ("vertex_pred", 0.001)):
        w = params[name]["weights"]
        assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6)
        assert abs(w.std() / (0.8796 * sigma) - 1) < 0.06, name
    assert np.abs(params["score"]["weights"]).max() <= 0.02 * (1 + 1e-6)
    # same seed, same weights; another seed, other weights
    again = init_params_numpy(0, PoseCNNConfig(**SMALL))
    np.testing.assert_array_equal(again["fc6"]["weights"], params["fc6"]["weights"])
    other = init_params_numpy(1, PoseCNNConfig(**SMALL))
    assert not np.array_equal(other["fc6"]["weights"], params["fc6"]["weights"])


def test_port_imports_no_jax():
    """Every module of posecnn_torch (the whole package, walked) imports
    without jax, posecnn_tpu, yaml or cv2 (the card's machine has neither
    PyYAML nor cv2: the port reads its .yml configs and makes its host
    images itself), the cfg-driven modules and `posecnn_torch.parallel`
    among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import posecnn_torch\n"
        "for m in pkgutil.walk_packages(posecnn_torch.__path__, 'posecnn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'yaml', 'cv2')\n"
        "             or k.startswith(('jax.', 'yaml.', 'cv2.', 'posecnn_tpu')))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(k for k in sys.modules if k.startswith('posecnn_torch'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 15
    assert {"posecnn_torch.core.config", "posecnn_torch.data.toy", "posecnn_torch.data.factory",
            "posecnn_torch.data.layer", "posecnn_torch.train_net", "posecnn_torch.test_net",
            "posecnn_torch.utils.blob", "posecnn_torch.models.fcn8", "posecnn_torch.models.factory",
            "posecnn_torch.parallel.mesh", "posecnn_torch.parallel.launch", "posecnn_torch.parallel.tp",
            "posecnn_torch.parallel.dryrun", "posecnn_torch.utils.gate_batch"} <= mods
