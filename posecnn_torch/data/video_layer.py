"""The video models' data layer: windows of consecutive frames of a video.

Port of `posecnn_tpu/data/video_layer.py`: `group_by_video` groups a
dataset's '<seq>/<frame>' indices by sequence; `GtDataLayer` draws, for
each of the batch's videos, a video (`rng.randint` over the sorted names,
up to 100 tries for one of at least T frames) and then the window's start,
from one `RandomState(seed)` in the JAX package's order, so its batches are
bit-equal to JAX's. A batch is (T,B,...): `data` float32 BGR less the pixel
means, `gt_label_2d` int32, `depth` float32 in metres (zeros for a frame
without depth) and `meta_data` float32 (K, K^-1 and the camera motion:
pose_world2live [18:30] of each frame against the window's first,
pose_live2world [30:42] its inverse).

No loader sets `Frame.camera_pose`, in either package, so every window
carries the identity motion, as JAX's does: in the repository a "video" is
a run of frozen frames of unrelated scenes.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from posecnn_torch.utils.meta import build_meta_data
from posecnn_torch.utils.se3 import se3_inverse, se3_mul


def group_by_video(image_index: List[str]) -> Dict[str, List[int]]:
    """'<seq>/<frame>' indices -> {seq: the frames' positions in order};
    an index without '/' belongs to the video 'all'."""
    videos = defaultdict(list)
    for i, name in enumerate(image_index):
        videos[name.split("/")[0] if "/" in name else "all"].append(i)
    return dict(videos)


class GtDataLayer:
    """Windows of `num_steps` consecutive frames, `ims_per_batch` videos a
    batch (`layer.py:31-55`)."""

    def __init__(self, dataset, mcfg, num_steps: int = 5, ims_per_batch: int = 1, seed: int = 3):
        self.dataset = dataset
        self.mcfg = mcfg
        self.num_steps = num_steps
        self.ims_per_batch = ims_per_batch
        self.rng = np.random.RandomState(seed)
        self.videos = group_by_video(dataset.image_index)
        self.video_names = sorted(self.videos)

    def _sample_window(self) -> List[int]:
        for _ in range(100):
            frames = self.videos[self.video_names[self.rng.randint(len(self.video_names))]]
            if len(frames) >= self.num_steps:
                start = self.rng.randint(0, len(frames) - self.num_steps + 1)
                return frames[start:start + self.num_steps]
        raise RuntimeError("no video long enough for the requested window")

    def forward(self) -> Dict[str, np.ndarray]:
        """The next batch, each blob (T,B,...)."""
        datas, labels, depths, metas = [], [], [], []
        for _ in range(self.ims_per_batch):
            frames = [self.dataset.load_frame(i) for i in self._sample_window()]
            rt_world = getattr(frames[0], "camera_pose", None)
            seq = ([], [], [], [])
            for fr in frames:
                seq[0].append((fr.color.astype(np.float32) - self.mcfg.pixel_means).astype(np.float32))
                seq[1].append(fr.label.astype(np.int32))
                seq[2].append(fr.depth.astype(np.float32) / fr.factor_depth if fr.depth is not None
                              else np.zeros(fr.label.shape, np.float32))
                mdata = build_meta_data(fr.intrinsic_matrix)
                rt_live = getattr(fr, "camera_pose", None)
                if rt_live is not None and rt_world is not None:
                    w2l = se3_mul(rt_live, se3_inverse(rt_world))
                    l2w = se3_inverse(w2l)
                else:
                    w2l = l2w = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
                mdata[18:30] = w2l.flatten()
                mdata[30:42] = l2w.flatten()
                seq[3].append(mdata)
            for blob, x in zip((datas, labels, depths, metas), seq):
                blob.append(x)

        def stack(lists):  # (B,T,...) -> (T,B,...)
            return np.stack([np.stack(x) for x in lists]).swapaxes(0, 1)

        return {"data": stack(datas).astype(np.float32), "gt_label_2d": stack(labels).astype(np.int32),
                "depth": stack(depths).astype(np.float32), "meta_data": stack(metas).astype(np.float32)}

    def __iter__(self):
        while True:
            yield self.forward()
