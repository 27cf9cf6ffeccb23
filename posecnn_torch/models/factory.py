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
`video3d_forward`). The JAX package's other names (`dcgan`, `vgg16_gan`)
raise NotImplementedError naming the network; a name it does not know
raises KeyError, as there.
"""

from __future__ import annotations

from typing import Callable, Tuple

# every name of the JAX package's registry
JAX_NETWORKS = ("dcgan", "fcn8_vgg", "resnet50", "vgg16", "vgg16_3d", "vgg16_convs", "vgg16_det", "vgg16_full",
                "vgg16_gan")


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
    if name in JAX_NETWORKS:
        raise NotImplementedError(f"network {name!r} is not ported yet (ported: fcn8_vgg, resnet50, vgg16, vgg16_3d, "
                                  "vgg16_convs, vgg16_det, vgg16_full)")
    raise KeyError(f"Unknown network: {name}. Known: {sorted(JAX_NETWORKS)}")
