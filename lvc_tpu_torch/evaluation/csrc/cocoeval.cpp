// Native COCOeval matching kernel.
//
// A copy of lvc_tpu/evaluation/csrc/cocoeval.cpp (the port keeps its own),
// counterpart of the reference's C++ COCOeval accelerator
// (detectron2/layers/csrc/cocoeval/cocoeval.cpp driven by
// evaluation/fast_eval_api.py). Exposed through a plain C ABI and loaded
// with ctypes, so no pybind11 is needed. The Python side keeps the IoU
// computation vectorized in numpy and calls this for the greedy
// per-(image, category) match across all IoU thresholds and area ranges.
//
// Semantics identical to lvc_tpu_torch/evaluation/coco_eval.py::evaluateImg:
//  - detections in descending score order greedily claim the highest-IoU
//    available gt above threshold
//  - already-matched gt are unavailable unless crowd
//  - once a non-ignored best match exists, ignored gts (sorted last) stop
//    the scan
//  - unmatched detections outside the area range are ignored
//
// Built by lvc_tpu_torch/utils/native_build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Evaluate one (image, category) cell for A area ranges and T thresholds.
//
// Inputs:
//   T, thrs[T]         IoU thresholds
//   D                  number of detections (already score-sorted, capped)
//   G                  number of ground truths (ORIGINAL order)
//   ious[D*G]          IoU matrix in original gt order
//   gt_area[G]         gt areas
//   gt_ignore_base[G]  gt 'ignore or iscrowd' base flag
//   gt_crowd[G]        gt iscrowd flag
//   dt_area[D]         det areas
//   A, area_rng[A*2]   area ranges (lo, hi)
//
// Outputs (caller-allocated):
//   dtm[A*T*D]   matched gt ORIGINAL index + 1, or 0
//   gtm[A*T*G]   matching det index + 1, or 0 (original gt order)
//   dt_ig[A*T*D] detection-ignore flags (0/1)
//   gt_ig[A*G]   per-area gt ignore flags (0/1), original order
void cocoeval_evaluate_img(
    int64_t T, const double* thrs,
    int64_t D, int64_t G,
    const double* ious,
    const double* gt_area,
    const uint8_t* gt_ignore_base,
    const uint8_t* gt_crowd,
    const double* dt_area,
    int64_t A, const double* area_rng,
    int64_t* dtm, int64_t* gtm, uint8_t* dt_ig, uint8_t* gt_ig) {
  std::vector<int64_t> order(G);
  for (int64_t a = 0; a < A; ++a) {
    const double lo = area_rng[a * 2], hi = area_rng[a * 2 + 1];
    uint8_t* gig = gt_ig + a * G;
    for (int64_t g = 0; g < G; ++g) {
      gig[g] = (gt_ignore_base[g] || gt_area[g] < lo || gt_area[g] > hi) ? 1 : 0;
    }
    // stable sort gt: non-ignored first (matches np.argsort(kind=mergesort))
    for (int64_t g = 0; g < G; ++g) order[g] = g;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t x, int64_t y) { return gig[x] < gig[y]; });

    for (int64_t t = 0; t < T; ++t) {
      int64_t* dtm_at = dtm + (a * T + t) * D;
      int64_t* gtm_at = gtm + (a * T + t) * G;
      std::memset(dtm_at, 0, sizeof(int64_t) * D);
      std::memset(gtm_at, 0, sizeof(int64_t) * G);
      uint8_t* dig = dt_ig + (a * T + t) * D;
      std::memset(dig, 0, D);

      for (int64_t d = 0; d < D; ++d) {
        double best = thrs[t] < (1.0 - 1e-10) ? thrs[t] : (1.0 - 1e-10);
        int64_t m = -1;
        for (int64_t gi = 0; gi < G; ++gi) {
          const int64_t g = order[gi];
          if (gtm_at[g] > 0 && !gt_crowd[g]) continue;
          // best match so far is non-ignored and we reached the ignored
          // tail (gts are sorted non-ignored first) -> stop scanning
          if (m > -1 && gig[m] == 0 && gig[g] == 1) break;
          const double v = ious[d * G + g];
          if (v < best) continue;
          best = v;
          m = g;
        }
        if (m == -1) continue;
        dig[d] = gig[m];
        dtm_at[d] = m + 1;
        gtm_at[m] = d + 1;
      }
      // area-range ignores for unmatched detections
      for (int64_t d = 0; d < D; ++d) {
        if (dtm_at[d] == 0 && (dt_area[d] < lo || dt_area[d] > hi)) dig[d] = 1;
      }
    }
  }
}

// Batched variant: all (image, category) cells in ONE call. The per-cell
// ctypes argument conversion dominated the Python side (11 array casts x ~60k
// calls on a COCO-sized eval); here Python concatenates the cell arrays
// once and passes CSR-style offsets.
//   dcounts/gcounts[N]  per-cell D_k / G_k
//   iou_off[N]          element offset of cell k in ious (sum D_i*G_i)
//   d_off/g_off[N]      element offsets into dt/gt arrays (sum D_i / G_i)
// Outputs use the same offsets scaled by A*T (dtm/gtm/dt_ig) or A (gt_ig).
void cocoeval_evaluate_batch(
    int64_t T, const double* thrs,
    int64_t A, const double* area_rng,
    int64_t N,
    const int64_t* dcounts, const int64_t* gcounts,
    const int64_t* iou_off, const int64_t* d_off, const int64_t* g_off,
    const double* ious,
    const double* gt_area, const uint8_t* gt_ignore_base,
    const uint8_t* gt_crowd, const double* dt_area,
    int64_t* dtm, int64_t* gtm, uint8_t* dt_ig, uint8_t* gt_ig) {
  for (int64_t k = 0; k < N; ++k) {
    cocoeval_evaluate_img(
        T, thrs, dcounts[k], gcounts[k], ious + iou_off[k],
        gt_area + g_off[k], gt_ignore_base + g_off[k], gt_crowd + g_off[k],
        dt_area + d_off[k], A, area_rng,
        dtm + A * T * d_off[k], gtm + A * T * g_off[k],
        dt_ig + A * T * d_off[k], gt_ig + A * g_off[k]);
  }
}

}  // extern "C"
