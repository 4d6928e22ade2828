"""KITTI AP machinery: difficulty filtering, greedy matching, PR curves, mAP
(the port's copy of ``tpu3d/evaluate/ap.py``).

One parameterized implementation of what the reference keeps as three ~780-line
copies (evaluate/eval2.py "new" distance metric, evaluate/eval_old.py "old"
height metric, pointrcnn/tools/eval.py). The per-image greedy matcher is
order-dependent and tiny, so it stays on the host (SURVEY.md §7 "hard
parts"): the C library ``csrc/ap_matcher.c`` through ``evaluate/native.py``
by default, the Python ``compute_statistics`` (its plain version) when the
caller passes ``use_native=False``. The O(N·K) rotated overlap matrices run
on the caller's device through ``evaluate/overlaps.py``.

Metric ids: 0 = image bbox, 1 = BEV, 2 = 3D.
Difficulty ids:
  old metric: 0/1/2 = easy/moderate/hard by 2D bbox height scaled per-dataset.
  new metric: 6 buckets — depth∈(0,30] occ≤0, (0,70] occ≤1, (0,70] occ≤2,
  (0,30], (30,50], (50,70] m (evaluate/eval2.py:37-50).
"""

from __future__ import annotations

import io as sysio

import numpy as np

from . import native
from .overlaps import calculate_iou_partly, get_split_parts, image_box_overlap

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting"]
CLASS_TO_NAME = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                 4: "Person_sitting"}

# per-dataset vertical focal lengths for the old metric's height thresholds
# (evaluate/eval_old.py:30-37)
FV_DICT = {"kitti": 707.05, "argo": 1870.57, "nusc": 1266.42, "lyft": 811.16,
           "waymo": 2069.82}

N_SAMPLE_PTS = 41
_NO_DETECTION = -10000000


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> list[float]:
    """Pick ≤41 score thresholds spaced ~evenly in recall
    (reference parity: evaluate/eval2.py:7-25 — including its quirky skip rule)."""
    scores = np.sort(scores)[::-1]
    num_gt = np.float64(max(num_gt, 1e-300))  # inf recall when no valid gt
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno: dict, dt_anno: dict, current_class: int, dataset: str,
               difficulty: int, metric_mode: str):
    """Per-image gt/dt eligibility.

    Returns (num_valid_gt, ignored_gt, ignored_dt, dc_bboxes) where ignored codes
    are 0 = evaluate, 1 = ignore-but-assignable, -1 = skip entirely
    (reference parity: evaluate/eval2.py:28-98 new, eval_old.py:28-91 old).
    """
    current_cls_name = CLASS_NAMES[current_class]
    num_gt, num_dt = len(gt_anno["name"]), len(dt_anno["name"])
    min_height = (np.array([40.0, 25.0, 25.0]) / FV_DICT["kitti"]
                  * FV_DICT[dataset])
    if metric_mode == "new":
        max_occlusion = [0, 1, 2, 2, 2, 2]
        max_truncation = [0.15, 0.3, 0.5, 0.5, 0.5, 0.5]
        dist_lo = [0, 0, 0, 0, 30, 50]
        dist_hi = [30, 70, 70, 30, 50, 70]
    else:
        max_occlusion = [0, 1, 2]
        max_truncation = [0.15, 0.3, 0.5]

    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(num_gt):
        gt_name = gt_anno["name"][i].lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1

        ignore = (gt_anno["occluded"][i] > max_occlusion[difficulty]
                  or gt_anno["truncated"][i] > max_truncation[difficulty])
        if metric_mode == "new":
            z = gt_anno["location"][i, 2]
            ignore = ignore or not (dist_lo[difficulty] < z < dist_hi[difficulty])
        else:
            ignore = ignore or height <= min_height[difficulty]

        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])

    for i in range(num_dt):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        if metric_mode == "new":
            z = dt_anno["location"][i, 2]
            out_of_band = not (dist_lo[difficulty] < z < dist_hi[difficulty])
            if out_of_band:
                ignored_dt.append(1)
            elif valid_class == 1:
                ignored_dt.append(0)
            else:
                ignored_dt.append(-1)
        else:
            height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
            if height < min_height[difficulty]:
                ignored_dt.append(1)
            elif valid_class == 1:
                ignored_dt.append(0)
            else:
                ignored_dt.append(-1)

    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(overlaps: np.ndarray, gt_datas: np.ndarray,
                       dt_datas: np.ndarray, ignored_gt, ignored_det,
                       dc_bboxes: np.ndarray, metric: int, min_overlap: float,
                       thresh: float = 0.0, compute_fp: bool = False,
                       compute_aos: bool = False):
    """Greedy per-image gt→dt assignment and TP/FP/FN/similarity counts.

    Faithful host re-implementation of evaluate/eval2.py:172-290 (the
    order-dependent two-mode matcher): without compute_fp, each gt takes the
    highest-*score* unassigned detection above min_overlap (ignorable dets
    allowed); with compute_fp, each gt prefers the highest-*overlap* non-ignored
    det, falling back to an ignorable det only when nothing else matched.
    """
    det_size, gt_size = dt_datas.shape[0], gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [dt_scores[i] < thresh if compute_fp else False
                         for i in range(det_size)]

    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False

        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == _NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != _NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned_detection[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned_detection[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            if tp > 0 or fp > 0:
                similarity = float(np.sum((1.0 + np.cos(delta)) / 2.0))
            else:
                similarity = -1
    return tp, fp, fn, similarity, np.array(thresholds)


def _flatten_ragged(arrs: list[np.ndarray], dtype) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate per-image arrays; return (flat, int64 start offsets)."""
    sizes = np.array([a.size if a.ndim == 1 else len(a) for a in arrs],
                     dtype=np.int64)
    offsets = np.zeros(len(arrs), dtype=np.int64)
    if len(arrs) > 1:
        offsets[1:] = np.cumsum(sizes)[:-1]
    if arrs:
        flat = np.ascontiguousarray(np.concatenate([a.ravel() for a in arrs]),
                                    dtype=dtype)
    else:
        flat = np.zeros(0, dtype=dtype)
    return flat, offsets


def eval_class(gt_annos: list[dict], dt_annos: list[dict], current_classes,
               dataset: str, difficultys, metric: int, min_overlaps: np.ndarray,
               metric_mode: str = "new", compute_aos: bool = False,
               num_parts: int = 50, use_native: bool = True,
               device=None) -> dict:
    """PR curves per (class, difficulty, min_overlap); reference parity:
    evaluate/eval2.py:462-568. The greedy matcher runs in the native C
    library (``evaluate/native.py``, which raises if it cannot be built),
    or in Python with ``use_native=False``; the rotated overlaps on
    ``device`` (default ``cuda``)."""
    assert len(gt_annos) == len(dt_annos)
    num_examples = len(gt_annos)
    split_parts = get_split_parts(num_examples, num_parts)
    overlaps, parted_overlaps, total_dt_num, total_gt_num = calculate_iou_partly(
        dt_annos, gt_annos, metric, num_parts, device)

    if use_native:
        ov64 = [np.ascontiguousarray(o, dtype=np.float64) for o in overlaps]
        ov_flat, ov_off = _flatten_ragged([o.reshape(-1) for o in ov64],
                                          np.float64)
        dt_nums = np.ascontiguousarray(total_dt_num, dtype=np.int64)
        gt_nums = np.ascontiguousarray(total_gt_num, dtype=np.int64)

    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            gt_datas_list, dt_datas_list = [], []
            ignored_gts, ignored_dets, dontcares = [], [], []
            total_num_valid_gt = 0
            for i in range(num_examples):
                num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
                    gt_annos[i], dt_annos[i], current_class, dataset, difficulty,
                    metric_mode)
                ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
                ignored_dets.append(np.array(ignored_det, dtype=np.int64))
                dontcares.append(
                    np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes
                    else np.zeros((0, 4), dtype=np.float64))
                total_num_valid_gt += num_valid_gt
                gt_datas_list.append(np.concatenate(
                    [gt_annos[i]["bbox"], gt_annos[i]["alpha"][:, None]], 1))
                dt_datas_list.append(np.concatenate(
                    [dt_annos[i]["bbox"], dt_annos[i]["alpha"][:, None],
                     dt_annos[i]["score"][:, None]], 1))

            if use_native:
                dt_scores_flat, dt_off = _flatten_ragged(
                    [d[:, -1] for d in dt_datas_list], np.float64)
                dt_alphas_flat, _ = _flatten_ragged(
                    [d[:, 4] for d in dt_datas_list], np.float64)
                gt_alphas_flat, gt_off = _flatten_ragged(
                    [g[:, 4] for g in gt_datas_list], np.float64)
                ig_gt_flat, _ = _flatten_ragged(ignored_gts, np.int64)
                ig_dt_flat, _ = _flatten_ragged(ignored_dets, np.int64)
                dc_nums = np.array([len(d) for d in dontcares], dtype=np.int64)
                if metric == 0:
                    dc_ov = [
                        np.ascontiguousarray(
                            image_box_overlap(dt_datas_list[i][:, :4],
                                              dontcares[i], 0), dtype=np.float64)
                        for i in range(num_examples)
                    ]
                else:
                    dc_ov = [np.zeros((0,)) for _ in range(num_examples)]
                dc_flat, dc_off = _flatten_ragged(
                    [d.reshape(-1) for d in dc_ov], np.float64)

            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                if use_native:
                    thresholdss = native.collect_tp_scores(
                        dt_nums, gt_nums, ov_flat, ov_off, dt_scores_flat,
                        dt_off, ig_gt_flat, gt_off, ig_dt_flat, min_overlap)
                else:
                    thresholdss = []
                    for i in range(num_examples):
                        *_, th = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i], metric,
                            min_overlap=min_overlap, thresh=0.0, compute_fp=False)
                        thresholdss += th.tolist()
                    thresholdss = np.array(thresholdss)
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                if use_native and len(thresholds) > 0:
                    pr = native.fused_statistics(
                        dt_nums, gt_nums, dc_nums, ov_flat, ov_off,
                        dt_scores_flat, dt_alphas_flat, dt_off,
                        gt_alphas_flat, ig_gt_flat, gt_off, ig_dt_flat,
                        dc_flat, dc_off, metric, min_overlap, thresholds,
                        compute_aos)
                elif not use_native:
                    for i in range(num_examples):
                        for t, thresh in enumerate(thresholds):
                            tp, fp, fn, similarity, _ = compute_statistics(
                                overlaps[i], gt_datas_list[i], dt_datas_list[i],
                                ignored_gts[i], ignored_dets[i], dontcares[i],
                                metric, min_overlap=min_overlap, thresh=thresh,
                                compute_fp=True, compute_aos=compute_aos)
                            pr[t, 0] += tp
                            pr[t, 1] += fp
                            pr[t, 2] += fn
                            if similarity != -1:
                                pr[t, 3] += similarity
                with np.errstate(invalid="ignore", divide="ignore"):
                    for i in range(len(thresholds)):
                        recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                        precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                        if compute_aos:
                            aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                # monotone envelope from the right
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:])
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:])
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec: np.ndarray) -> np.ndarray:
    """11-point interpolated AP from the 41-sample PR curve (every 4th sample;
    reference: evaluate/eval2.py:571-575)."""
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def do_eval(gt_annos, dt_annos, current_classes, dataset, min_overlaps,
            metric_mode="new", compute_aos=False, use_native=True,
            device=None):
    difficultys = list(range(6 if metric_mode == "new" else 3))
    kw = dict(use_native=use_native, device=device)
    ret = eval_class(gt_annos, dt_annos, current_classes, dataset, difficultys, 0,
                     min_overlaps, metric_mode, compute_aos, **kw)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_aos = get_mAP(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, dataset, difficultys, 1,
                     min_overlaps, metric_mode, **kw)
    mAP_bev = get_mAP(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, dataset, difficultys, 2,
                     min_overlaps, metric_mode, **kw)
    mAP_3d = get_mAP(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def _print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             dataset="kitti", metric_mode="new",
                             dense_sample=False, use_native=True, device=None):
    """AP at IoU 0.7/0.5 (+ optional dense 0..1 sweep); returns (report string,
    dict). Reference parity: evaluate/eval2.py:629-722 / eval_old.py."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25]])
    extra = []
    if dense_sample:
        for i in range(101):
            tmp = np.zeros((3, 5))
            tmp[:, 0] = i / 100.0
            extra.append(tmp)
    min_overlaps = np.stack([overlap_0_7, overlap_0_5] + extra, axis=0)

    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, dataset, min_overlaps, metric_mode,
        compute_aos, use_native, device)

    n_diff = 6 if metric_mode == "new" else 3
    result = ""
    res = {}
    for j, curcls in enumerate(current_classes):
        res[curcls] = {}
        for i in range(min_overlaps.shape[0]):
            key = (f"{CLASS_TO_NAME[curcls]} "
                   + "AP@{:.2f}, {:.2f}, {:.2f}".format(*min_overlaps[i, :, j]))
            res[curcls][key] = {
                "mAPbbox": mAPbbox[j, :, i],
                "mAPbev": mAPbev[j, :, i],
                "mAP3d": mAP3d[j, :, i],
            }
            result += _print_str(key + ":")
            result += _print_str("bbox AP:" + ", ".join(
                f"{mAPbbox[j, d, i]:.4f}" for d in range(n_diff)))
            result += _print_str("bev  AP:" + ", ".join(
                f"{mAPbev[j, d, i]:.4f}" for d in range(n_diff)))
            result += _print_str("3d   AP:" + ", ".join(
                f"{mAP3d[j, d, i]:.4f}" for d in range(n_diff)))
            if compute_aos:
                res[curcls][key]["mAPaos"] = mAPaos[j, :, i]
                result += _print_str("aos  AP:" + ", ".join(
                    f"{mAPaos[j, d, i]:.2f}" for d in range(n_diff)))

    ret_dict = {
        "Car_3d_easy": mAP3d[0, 0, 0],
        "Car_3d_moderate": mAP3d[0, 1, 0],
        "Car_3d_hard": mAP3d[0, 2, 0],
        "Car_bev_easy": mAPbev[0, 0, 0],
        "Car_bev_moderate": mAPbev[0, 1, 0],
        "Car_bev_hard": mAPbev[0, 2, 0],
        "Car_image_easy": mAPbbox[0, 0, 0],
        "Car_image_moderate": mAPbbox[0, 1, 0],
        "Car_image_hard": mAPbbox[0, 2, 0],
        "result": res,
    }
    return result, ret_dict


def get_coco_eval_result(gt_annos, dt_annos, current_classes, dataset="kitti",
                         metric_mode="new", use_native=True, device=None):
    """COCO-style AP over an overlap range (reference: eval2.py:611-626,725-784)."""
    class_to_range = {0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
                      3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10]}
    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    overlap_ranges = np.zeros([3, 3, len(current_classes)])
    for i, curcls in enumerate(current_classes):
        overlap_ranges[:, :, i] = np.array(class_to_range[curcls])[:, None]
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            start, stop, num = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(start, stop, int(num))
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, dataset, min_overlaps, metric_mode,
        compute_aos, use_native, device)
    mAPbbox, mAPbev, mAP3d = (m.mean(-1) for m in (mAPbbox, mAPbev, mAP3d))
    if mAPaos is not None:
        mAPaos = mAPaos.mean(-1)
    n_diff = 6 if metric_mode == "new" else 3
    result = ""
    for j, curcls in enumerate(current_classes):
        o_range = np.array(class_to_range[curcls])[[0, 2, 1]]
        o_range[1] = (o_range[2] - o_range[0]) / (o_range[1] - 1)
        result += _print_str(
            f"{CLASS_TO_NAME[curcls]} "
            + "coco AP@{:.2f}:{:.2f}:{:.2f}:".format(*o_range))
        result += _print_str("bbox AP:" + ", ".join(
            f"{mAPbbox[j, d]:.2f}" for d in range(n_diff)))
        result += _print_str("bev  AP:" + ", ".join(
            f"{mAPbev[j, d]:.2f}" for d in range(n_diff)))
        result += _print_str("3d   AP:" + ", ".join(
            f"{mAP3d[j, d]:.2f}" for d in range(n_diff)))
        if compute_aos:
            result += _print_str("aos  AP:" + ", ".join(
                f"{mAPaos[j, d]:.2f}" for d in range(n_diff)))
    return result
