"""Network factory: name -> (init_fn, forward_fn).

Port of `posecnn_tpu/models/factory.py` for the networks the port runs:
`vgg16_convs` (PoseCNN: `core.convert.init_params_numpy`,
`models.posecnn.posecnn_forward`), `vgg16_full` (the all-scale variant:
`models.posecnn_full.init_posecnn_full_params_numpy`,
`posecnn_full_forward`), `fcn8_vgg` (FCN-8s:
`models.fcn8.init_fcn8_params_numpy`, `fcn8_forward`) and `vgg16_det`
(the detection network: `models.detection.init_vgg16_det_params_numpy`,
`vgg16_det_forward`), `resnet50` (the segmentation network:
`models.resnet50.init_resnet50_params_numpy`, `resnet50_forward`), and
the video models `vgg16` (`models.video.init_video_params_numpy`,
`video_forward`) and `vgg16_3d` (`init_video3d_params_numpy`,
`video3d_forward`), and the GAN models `dcgan`
(`models.gan.init_dcgan_params_numpy`, `dcgan_generator`) and `vgg16_gan`
(`init_vgg16_gan_params_numpy`, `vgg16_gan_forward`): every name of the
JAX package's registry. A name it does not know raises KeyError, as
there. (The CLIs train and score PoseCNN for the flags `dcgan` and
`vgg16_gan`, as JAX's do: `core/config.py:pick_network`.)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

# every name of the JAX package's registry
JAX_NETWORKS = ("dcgan", "fcn8_vgg", "resnet50", "vgg16", "vgg16_3d", "vgg16_convs", "vgg16_det", "vgg16_full",
                "vgg16_gan")


# networks added with `register`, looked up after the built-in names
_REGISTERED: Dict[str, Tuple[Callable, Callable]] = {}


def register(name: str, init_fn: Callable, forward_fn: Callable) -> None:
    """Add network `name` (`factory.py:register`). A built-in name raises
    ValueError: it has one lookup, below."""
    if name in JAX_NETWORKS:
        raise ValueError(f"network {name!r} is built in")
    _REGISTERED[name] = (init_fn, forward_fn)


def list_networks() -> List[str]:
    return sorted(set(JAX_NETWORKS) | set(_REGISTERED))


def get_network(name: str) -> Tuple[Callable, Callable]:
    if name == "vgg16_convs":
        from posecnn_torch.core.convert import init_params_numpy
        from posecnn_torch.models.posecnn import posecnn_forward

        return init_params_numpy, posecnn_forward
    if name == "vgg16_full":
        from posecnn_torch.models.posecnn_full import init_posecnn_full_params_numpy, posecnn_full_forward

        return init_posecnn_full_params_numpy, posecnn_full_forward
    if name == "fcn8_vgg":
        from posecnn_torch.models.fcn8 import fcn8_forward, init_fcn8_params_numpy

        return init_fcn8_params_numpy, fcn8_forward
    if name == "vgg16_det":
        from posecnn_torch.models.detection import init_vgg16_det_params_numpy, vgg16_det_forward

        return init_vgg16_det_params_numpy, vgg16_det_forward
    if name == "resnet50":
        from posecnn_torch.models.resnet50 import init_resnet50_params_numpy, resnet50_forward

        return init_resnet50_params_numpy, resnet50_forward
    if name == "vgg16":
        from posecnn_torch.models.video import init_video_params_numpy, video_forward

        return init_video_params_numpy, video_forward
    if name == "vgg16_3d":
        from posecnn_torch.models.video import init_video3d_params_numpy, video3d_forward

        return init_video3d_params_numpy, video3d_forward
    if name == "dcgan":
        from posecnn_torch.models.gan import dcgan_generator, init_dcgan_params_numpy

        return init_dcgan_params_numpy, dcgan_generator
    if name == "vgg16_gan":
        from posecnn_torch.models.gan import init_vgg16_gan_params_numpy, vgg16_gan_forward

        return init_vgg16_gan_params_numpy, vgg16_gan_forward
    if name in _REGISTERED:
        return _REGISTERED[name]
    raise KeyError(f"Unknown network: {name}. Known: {list_networks()}")
