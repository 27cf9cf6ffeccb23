"""The dataset base class, and pose evaluation: segmentation IoU, ADD(-S)
accuracy and AUC.

The port's own copy of `posecnn_tpu/data/imdb.py`: the `imdb` base class
(`roidb`, `num_images`, `append_flipped_images`), `fast_hist` and
`PoseEvaluator` (numpy), with the YCB-Video classes scored with ADD-S
(`posecnn_tpu/data/lov.py:39`; the class names are in `data/lov.py`).

`append_flipped_images` appends a flipped copy of every roidb entry and
doubles the image index, so a dataset of N frames then has 2N entries. The
training layer reads entry i >= N as `load_frame(i)` mirrored: for a
procedural dataset (`data/toy.py`) that is a new scene, not a mirror of
frame i - N, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from posecnn_torch.utils.pose_error import add, adi, re, reproj, te
from posecnn_torch.utils.quaternion_np import quat2mat
from posecnn_torch.utils.se3 import se3_mul

# classes evaluated with ADD-S at test time (lov.py:484-487)
YCB_SYMMETRIC_EVAL = ("024_bowl", "036_wood_block", "061_foam_brick")


class imdb:
    """Image database base (`posecnn_tpu/data/imdb.py:21-79`)."""

    def __init__(self, name: str):
        self._name = name
        self._classes: Sequence[str] = []
        self._image_index: List[str] = []
        self._roidb: Optional[List[Dict]] = None

    @property
    def name(self):
        return self._name

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def classes(self):
        return self._classes

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self._image_index)

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self.gt_roidb()
        return self._roidb

    def gt_roidb(self):
        raise NotImplementedError

    def append_flipped_images(self):
        """Horizontal-flip augmentation: the roidb gains a flipped copy of
        every entry, and the image index doubles."""
        roidb = self.roidb
        flipped = []
        for entry in roidb:
            e = dict(entry)
            e["flipped"] = True
            flipped.append(e)
        self._roidb = roidb + flipped
        self._image_index = self._image_index * 2


def fast_hist(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Confusion histogram (lib/datasets/imdb.py:123)."""
    k = (a >= 0) & (a < n)
    return np.bincount(n * a[k].astype(int) + b[k].astype(int), minlength=n ** 2).reshape(n, n)


class PoseEvaluator:
    """Accumulates segmentation IoU and pose errors over an eval run.

    Matching policy (the paper's protocol, not the reference's loose in-repo
    printout `lov.py:397-516` which pairs every detection with every same-class
    GT): detections are processed in descending score order and each claims at
    most one unclaimed ground-truth object of its class (greedy one-to-one).
    Every GT instance is scored — an undetected GT counts as an infinite-error
    record, so AUC and accuracy reflect recall, as in the YCB_Video_toolbox.

    Thresholds: 0.1 * ||extent|| per class by default (`lov.py:484-487`), or
    0.1 * diameter when `diameters` is given (LINEMOD protocol,
    `linemod.py:411-413`). With an `intrinsic_matrix` per frame, the 2D
    reprojection error (`pose_error.reproj`, linemod.py:481-542) is also
    recorded, with the eggbox/glue 180-degree z-flip correction for
    `flip_z_classes` whose rotation error exceeds 90 degrees.
    """

    MISS = float("inf")  # error recorded for an undetected GT instance

    def __init__(
        self,
        classes: Sequence[str],
        extents: np.ndarray,
        points: List,
        symmetric_classes: Sequence[str],
        diameters: Optional[np.ndarray] = None,
        flip_z_classes: Sequence[str] = (),
    ):
        self.classes = list(classes)
        self.num_classes = len(classes)
        self.extents = extents
        self.points = points
        self.symmetric = set(symmetric_classes)
        self.diameters = diameters
        self.flip_z_classes = set(flip_z_classes)
        self.hist = np.zeros((self.num_classes, self.num_classes))
        # per-class list of record dicts (keys: err, err_r, err_t, thresh,
        # optionally err_refined / err_icp / reproj / score)
        self.pose_errors: Dict[int, List[Dict]] = {c: [] for c in range(self.num_classes)}

    def _threshold(self, cls_index: int) -> float:
        if self.diameters is not None:
            return float(0.1 * self.diameters[cls_index])
        return float(0.1 * np.linalg.norm(self.extents[cls_index, :]))

    def _pose_errors(self, quat, trans, gt_pose, cls_index, K=None):
        """Errors of one (quat, translation) estimate vs one GT (3,4) pose."""
        cls = self.classes[cls_index]
        RT = np.zeros((3, 4), dtype=np.float32)
        RT[:3, :3] = quat2mat(np.asarray(quat, np.float64))
        RT[:, 3] = trans
        err_r = re(RT[:3, :3], gt_pose[:3, :3])
        err_t = te(RT[:, 3], gt_pose[:, 3])
        fn = adi if cls in self.symmetric else add
        err = fn(RT[:3, :3], RT[:, 3], gt_pose[:3, :3], gt_pose[:, 3], self.points[cls_index])
        dt = np.asarray(trans, np.float64) - gt_pose[:, 3]
        rec = {
            "err": err, "err_r": err_r, "err_t": err_t,
            "err_t_xy": float(np.linalg.norm(dt[:2])), "err_t_z": float(abs(dt[2])),
        }
        if K is not None:
            RT_p = RT
            if cls in self.flip_z_classes and err_r > 90:
                # 180-degree z-rotation symmetry fix (linemod.py:503-507)
                RT_z = np.array([[-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 0]], np.float64)
                RT_p = se3_mul(RT, RT_z)
            rec["reproj"] = reproj(
                K, RT_p[:3, :3], RT_p[:, 3], gt_pose[:3, :3], gt_pose[:, 3], self.points[cls_index]
            )
        return rec

    def add_frame(
        self,
        pred_labels: np.ndarray,
        gt_labels: np.ndarray,
        rois: Optional[np.ndarray] = None,
        poses: Optional[np.ndarray] = None,
        gt_poses: Optional[np.ndarray] = None,
        gt_cls_indexes: Optional[np.ndarray] = None,
        poses_refined: Optional[np.ndarray] = None,
        poses_icp: Optional[np.ndarray] = None,
        intrinsic_matrix: Optional[np.ndarray] = None,
    ):
        self.hist += fast_hist(
            gt_labels.astype(np.float32).flatten(), pred_labels.flatten(), self.num_classes
        )
        if gt_poses is None:
            return
        if gt_poses.ndim == 2:
            gt_poses = gt_poses.reshape(3, 4, 1)

        n_gt = gt_poses.shape[2]
        gt_taken = np.zeros(n_gt, bool)
        if rois is not None and rois.shape[0] > 0 and poses is not None:
            order = np.argsort(-rois[:, 6]) if rois.shape[1] > 6 else np.arange(rois.shape[0])
            for k in order:
                cls_index = int(rois[k, 1])
                if cls_index <= 0:
                    continue
                # unclaimed GT of this class, nearest in translation
                best_j, best_d = -1, np.inf
                for j in range(n_gt):
                    if gt_taken[j] or int(gt_cls_indexes[j]) != cls_index:
                        continue
                    d = float(np.linalg.norm(poses[k, 4:7] - gt_poses[:, 3, j]))
                    if d < best_d:
                        best_j, best_d = j, d
                if best_j < 0:
                    continue
                gt_taken[best_j] = True
                gt = gt_poses[:, :, best_j]
                rec = self._pose_errors(poses[k, :4], poses[k, 4:7], gt, cls_index, intrinsic_matrix)
                rec["thresh"] = self._threshold(cls_index)
                rec["score"] = float(rois[k, 6]) if rois.shape[1] > 6 else 0.0
                if poses_refined is not None:
                    rec["err_refined"] = self._pose_errors(
                        poses_refined[k, :4], poses_refined[k, 4:7], gt, cls_index
                    )["err"]
                if poses_icp is not None:
                    rec["err_icp"] = self._pose_errors(
                        poses_icp[k, :4], poses_icp[k, 4:7], gt, cls_index
                    )["err"]
                self.pose_errors[cls_index].append(rec)

        for j in range(n_gt):
            cls_index = int(gt_cls_indexes[j])
            if cls_index <= 0 or gt_taken[j]:
                continue
            rec = {
                "err": self.MISS, "err_r": self.MISS, "err_t": self.MISS,
                "thresh": self._threshold(cls_index), "score": 0.0,
            }
            if poses_refined is not None:
                rec["err_refined"] = self.MISS
            if poses_icp is not None:
                rec["err_icp"] = self.MISS
            if intrinsic_matrix is not None:
                rec["reproj"] = self.MISS
            self.pose_errors[cls_index].append(rec)

    def segmentation_iou(self) -> Dict[str, float]:
        intersection = np.diag(self.hist)
        union = self.hist.sum(1) + self.hist.sum(0) - np.diag(self.hist)
        out = {}
        for i in range(self.num_classes):
            if union[i] > 0:
                out[self.classes[i]] = float(intersection[i] / union[i])
        return out

    # refined/ICP error keys are absent from records of frames where the
    # engine skipped refinement (e.g. zero detections -> poses_icp=None);
    # those GTs are misses for the refined metric too. Reading them as MISS
    # keeps adds_auc_icp over the SAME population as adds_auc — dropping
    # them would exclude exactly the hardest frames and inflate the metric.
    _MISS_DEFAULT_KEYS = ("err_refined", "err_icp")

    def _rec_err(self, r: dict, key: str):
        if key in r:
            return r[key]
        return self.MISS if key in self._MISS_DEFAULT_KEYS else None

    def pose_accuracy(self, key: str = "err") -> Dict[str, float]:
        """Fraction of GT instances with ADD(-S) < threshold per class."""
        out = {}
        for c, recs in self.pose_errors.items():
            vals = [
                (e, r["thresh"])
                for r in recs
                for e in [self._rec_err(r, key)]
                if e is not None
            ]
            if vals:
                out[self.classes[c]] = sum(1 for e, t in vals if e < t) / len(vals)
        return out

    def reproj_accuracy(self, px_threshold: float = 5.0) -> Dict[str, float]:
        """LINEMOD 2D-projection metric: mean reprojection error < 5 px."""
        out = {}
        for c, recs in self.pose_errors.items():
            vals = [r["reproj"] for r in recs if "reproj" in r]
            if vals:
                out[self.classes[c]] = sum(1 for e in vals if e < px_threshold) / len(vals)
        return out

    @staticmethod
    def _auc(errs: np.ndarray, max_threshold: float) -> float:
        """Area under the accuracy-vs-threshold curve over [0, max_threshold]."""
        errs = np.sort(np.asarray(errs, np.float64))
        n = len(errs)
        if n == 0:
            return 0.0
        prev_t, prev_a, area = 0.0, 0.0, 0.0
        for i, e in enumerate(errs):
            if e >= max_threshold:
                break
            area += prev_a * (e - prev_t)
            prev_t, prev_a = e, (i + 1) / n
        area += prev_a * (max_threshold - prev_t)
        return float(area / max_threshold)

    def adds_auc_per_class(self, max_threshold: float = 0.1, key: str = "err") -> Dict[str, float]:
        """Per-class area under the ADD(-S) accuracy-threshold curve up to
        10 cm — the headline YCB-Video metric from the PoseCNN paper.
        Undetected GTs (err=inf) drag the curve down, as in the toolbox."""
        out = {}
        for c, recs in self.pose_errors.items():
            errs = [e for r in recs for e in [self._rec_err(r, key)] if e is not None]
            if errs:
                out[self.classes[c]] = self._auc(np.array(errs), max_threshold)
        return out

    def adds_auc(self, max_threshold: float = 0.1, key: str = "err") -> float:
        """Mean of the per-class AUCs (paper table metric)."""
        per_class = self.adds_auc_per_class(max_threshold, key)
        return float(np.mean(list(per_class.values()))) if per_class else 0.0

    def adds_auc_pooled(self, max_threshold: float = 0.1, key: str = "err") -> float:
        """All classes pooled into one curve (not the paper metric)."""
        errs = [
            e
            for recs in self.pose_errors.values()
            for r in recs
            for e in [self._rec_err(r, key)]
            if e is not None
        ]
        return self._auc(np.array(errs), max_threshold) if errs else 0.0

    def summary(self) -> Dict[str, object]:
        seg_iou = self.segmentation_iou()
        out = {
            "seg_iou": seg_iou,
            "mean_iou": float(np.mean(list(seg_iou.values()) or [0.0])),
            "pose_accuracy": self.pose_accuracy(),
            "adds_auc": self.adds_auc(),
            "adds_auc_per_class": self.adds_auc_per_class(),
            "adds_auc_pooled": self.adds_auc_pooled(),
        }
        matched = [
            r for recs in self.pose_errors.values() for r in recs
            if np.isfinite(r["err"])
        ]
        n_total = sum(len(recs) for recs in self.pose_errors.values())
        if n_total:
            out["detection_recall"] = len(matched) / n_total
        if matched:
            # decomposition: is AUC limited by translation (hough voting /
            # depth head) or rotation (quaternion head)?
            out["median_err_t"] = float(np.median([r["err_t"] for r in matched]))
            out["median_err_t_xy"] = float(np.median([r["err_t_xy"] for r in matched if "err_t_xy" in r]))
            out["median_err_t_z"] = float(np.median([r["err_t_z"] for r in matched if "err_t_z" in r]))
            out["median_err_r_deg"] = float(np.median([r["err_r"] for r in matched]))
            out["median_add"] = float(np.median([r["err"] for r in matched]))
        has = lambda key: any(key in r for recs in self.pose_errors.values() for r in recs)
        if has("err_refined"):
            out["adds_auc_refined"] = self.adds_auc(key="err_refined")
            out["pose_accuracy_refined"] = self.pose_accuracy(key="err_refined")
        if has("err_icp"):
            out["adds_auc_icp"] = self.adds_auc(key="err_icp")
            out["pose_accuracy_icp"] = self.pose_accuracy(key="err_icp")
        if has("reproj"):
            out["reproj_accuracy"] = self.reproj_accuracy()
        return out
