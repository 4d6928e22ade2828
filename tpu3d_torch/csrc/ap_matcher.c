/* Native AP-matcher hot loop for the KITTI evaluator.
 *
 * The greedy gt->dt assignment (tpu3d_torch/evaluate/ap.py compute_statistics,
 * which is this library's plain version; reference semantics:
 * evaluate/eval2.py:172-349) is order-dependent and sequential per image, but
 * is called num_images x num_thresholds x metrics x difficulties x overlaps
 * times per eval run. The reference JIT-compiles it with numba; here it is a
 * small C library, built with the host C compiler and loaded through ctypes
 * by tpu3d_torch/evaluate/native.py, with a fused all-images x all-thresholds
 * entry point so one call per (class, difficulty, overlap, metric) covers the
 * whole dataset.
 *
 * Conventions match the python version exactly:
 *   ignored codes: 0 evaluate, 1 ignore-but-assignable, -1 skip
 *   overlaps are row-major (det_size, gt_size) per image
 *   dc_overlaps are row-major (det_size, dc_num) per image (metric 0 only)
 */

#include <stdlib.h>
#include <math.h>
#include <string.h>

#define NO_DETECTION -10000000.0

/* Single-image greedy matcher.
 * Returns tp; outputs fp/fn/similarity and matched tp scores. */
static void compute_statistics_one(
    const double *overlaps,      /* (det_size, gt_size) row-major */
    int det_size, int gt_size,
    const double *dt_scores, const double *dt_alphas, const double *gt_alphas,
    const long *ignored_gt, const long *ignored_det,
    const double *dc_overlaps,   /* (det_size, dc_num) or NULL */
    int dc_num,
    int metric, double min_overlap, double thresh,
    int compute_fp, int compute_aos,
    long *out_tp, long *out_fp, long *out_fn, double *out_similarity,
    double *out_thresholds, long *out_thresh_count,
    char *assigned, char *ignored_threshold /* scratch, det_size each */)
{
    long tp = 0, fp = 0, fn = 0;
    double similarity = 0.0;
    long thresh_idx = 0;
    double *delta_buf = NULL;
    long delta_idx = 0;
    if (compute_aos && gt_size > 0)
        delta_buf = (double *)malloc(sizeof(double) * (size_t)gt_size);

    memset(assigned, 0, (size_t)det_size);
    for (int j = 0; j < det_size; j++)
        ignored_threshold[j] = (compute_fp && dt_scores[j] < thresh) ? 1 : 0;

    for (int i = 0; i < gt_size; i++) {
        if (ignored_gt[i] == -1) continue;
        int det_idx = -1;
        double valid_detection = NO_DETECTION;
        double max_overlap = 0.0;
        int assigned_ignored_det = 0;

        for (int j = 0; j < det_size; j++) {
            if (ignored_det[j] == -1) continue;
            if (assigned[j]) continue;
            if (ignored_threshold[j]) continue;
            double overlap = overlaps[(size_t)j * gt_size + i];
            double dt_score = dt_scores[j];
            if (!compute_fp && overlap > min_overlap
                && dt_score > valid_detection) {
                det_idx = j;
                valid_detection = dt_score;
            } else if (compute_fp && overlap > min_overlap
                       && (overlap > max_overlap || assigned_ignored_det)
                       && ignored_det[j] == 0) {
                max_overlap = overlap;
                det_idx = j;
                valid_detection = 1.0;
                assigned_ignored_det = 0;
            } else if (compute_fp && overlap > min_overlap
                       && valid_detection == NO_DETECTION
                       && ignored_det[j] == 1) {
                det_idx = j;
                valid_detection = 1.0;
                assigned_ignored_det = 1;
            }
        }

        if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
            fn++;
        } else if (valid_detection != NO_DETECTION
                   && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
            assigned[det_idx] = 1;
        } else if (valid_detection != NO_DETECTION) {
            tp++;
            if (out_thresholds) out_thresholds[thresh_idx] = dt_scores[det_idx];
            thresh_idx++;
            if (compute_aos && delta_buf)
                delta_buf[delta_idx++] = gt_alphas[i] - dt_alphas[det_idx];
            assigned[det_idx] = 1;
        }
    }

    if (compute_fp) {
        for (int j = 0; j < det_size; j++) {
            if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1
                  || ignored_threshold[j]))
                fp++;
        }
        long nstuff = 0;
        if (metric == 0 && dc_overlaps != NULL) {
            for (int i = 0; i < dc_num; i++) {
                for (int j = 0; j < det_size; j++) {
                    if (assigned[j]) continue;
                    if (ignored_det[j] == -1 || ignored_det[j] == 1) continue;
                    if (ignored_threshold[j]) continue;
                    if (dc_overlaps[(size_t)j * dc_num + i] > min_overlap) {
                        assigned[j] = 1;
                        nstuff++;
                    }
                }
            }
        }
        fp -= nstuff;
        if (compute_aos) {
            if (tp > 0 || fp > 0) {
                for (long k = 0; k < delta_idx; k++)
                    similarity += (1.0 + cos(delta_buf[k])) / 2.0;
            } else {
                similarity = -1.0;
            }
        }
    }
    if (delta_buf) free(delta_buf);
    *out_tp = tp;
    *out_fp = fp;
    *out_fn = fn;
    *out_similarity = similarity;
    if (out_thresh_count) *out_thresh_count = thresh_idx;
}

/* Pass 1: collect matched tp scores across all images (compute_fp = false).
 * out_scores must hold sum(gt_nums). Returns total count. */
long collect_tp_scores(
    int num_images,
    const long *dt_nums, const long *gt_nums,
    const double *overlaps_flat, const long *overlap_offsets,
    const double *dt_scores_flat, const long *dt_offsets,
    const long *ignored_gt_flat, const long *gt_offsets,
    const long *ignored_det_flat,
    double min_overlap,
    double *out_scores)
{
    long total = 0;
    int max_det = 0;
    for (int im = 0; im < num_images; im++)
        if (dt_nums[im] > max_det) max_det = (int)dt_nums[im];
    char *assigned = (char *)malloc((size_t)(max_det > 0 ? max_det : 1));
    char *ignth = (char *)malloc((size_t)(max_det > 0 ? max_det : 1));

    for (int im = 0; im < num_images; im++) {
        long tp, fp, fn, cnt;
        double sim;
        compute_statistics_one(
            overlaps_flat + overlap_offsets[im],
            (int)dt_nums[im], (int)gt_nums[im],
            dt_scores_flat + dt_offsets[im], NULL, NULL,
            ignored_gt_flat + gt_offsets[im],
            ignored_det_flat + dt_offsets[im],
            NULL, 0,
            /*metric=*/-1, min_overlap, /*thresh=*/0.0,
            /*compute_fp=*/0, /*compute_aos=*/0,
            &tp, &fp, &fn, &sim, out_scores + total, &cnt,
            assigned, ignth);
        total += cnt;
    }
    free(assigned);
    free(ignth);
    return total;
}

/* Pass 2: accumulate PR over all images x all thresholds (compute_fp = true).
 * pr is (n_thresh, 4) row-major: tp, fp, fn, similarity. */
void fused_statistics(
    int num_images,
    const long *dt_nums, const long *gt_nums, const long *dc_nums,
    const double *overlaps_flat, const long *overlap_offsets,
    const double *dt_scores_flat, const double *dt_alphas_flat,
    const long *dt_offsets,
    const double *gt_alphas_flat, const long *ignored_gt_flat,
    const long *gt_offsets,
    const long *ignored_det_flat,
    const double *dc_overlaps_flat, const long *dc_offsets,
    int metric, double min_overlap,
    const double *thresholds, int n_thresh,
    int compute_aos,
    double *pr)
{
    int max_det = 0;
    for (int im = 0; im < num_images; im++)
        if (dt_nums[im] > max_det) max_det = (int)dt_nums[im];
    char *assigned = (char *)malloc((size_t)(max_det > 0 ? max_det : 1));
    char *ignth = (char *)malloc((size_t)(max_det > 0 ? max_det : 1));

    for (int im = 0; im < num_images; im++) {
        const double *dc = NULL;
        if (metric == 0 && dc_nums[im] > 0)
            dc = dc_overlaps_flat + dc_offsets[im];
        for (int t = 0; t < n_thresh; t++) {
            long tp, fp, fn;
            double sim;
            compute_statistics_one(
                overlaps_flat + overlap_offsets[im],
                (int)dt_nums[im], (int)gt_nums[im],
                dt_scores_flat + dt_offsets[im],
                dt_alphas_flat + dt_offsets[im],
                gt_alphas_flat + gt_offsets[im],
                ignored_gt_flat + gt_offsets[im],
                ignored_det_flat + dt_offsets[im],
                dc, (int)dc_nums[im],
                metric, min_overlap, thresholds[t],
                /*compute_fp=*/1, compute_aos,
                &tp, &fp, &fn, &sim, NULL, NULL,
                assigned, ignth);
            pr[(size_t)t * 4 + 0] += (double)tp;
            pr[(size_t)t * 4 + 1] += (double)fp;
            pr[(size_t)t * 4 + 2] += (double)fn;
            if (sim != -1.0) pr[(size_t)t * 4 + 3] += sim;
        }
    }
    free(assigned);
    free(ignth);
}
