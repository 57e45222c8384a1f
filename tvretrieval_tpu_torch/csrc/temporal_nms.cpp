// Temporal 1-D NMS on the host: the port's own copy of the JAX package's
// native/temporal_nms.cpp, the native path of
// tvretrieval_tpu_torch/evaluation/nms.py::temporal_nms (greedy keep-best
// with strict-> IoU suppression, float32), and its batched form over many
// queries delimited by offsets.
//
// Build: with the host C++ compiler at first use, by
// tvretrieval_tpu_torch/native/loader.py (into tvretrieval_tpu_torch/_build/).
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// preds: n rows of [st, ed, score]. Writes up to max_after kept rows into
// out (max_after * 3 floats); returns the number kept.
int temporal_nms(const float* preds, int n, float nms_threshold,
                 int max_after, float* out) {
  if (n <= 0) return 0;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return preds[a * 3 + 2] > preds[b * 3 + 2];
  });

  std::vector<char> alive(n, 1);
  int kept = 0;
  for (int oi = 0; oi < n && kept < max_after; ++oi) {
    const int i = order[oi];
    if (!alive[i]) continue;
    const float st_i = preds[i * 3], ed_i = preds[i * 3 + 1];
    out[kept * 3] = st_i;
    out[kept * 3 + 1] = ed_i;
    out[kept * 3 + 2] = preds[i * 3 + 2];
    ++kept;
    alive[i] = 0;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (!alive[j]) continue;
      const float st_j = preds[j * 3], ed_j = preds[j * 3 + 1];
      const float inter = std::max(0.f, std::min(ed_i, ed_j) - std::max(st_i, st_j));
      const float uni = std::max(ed_i, ed_j) - std::min(st_i, st_j);
      const float iou = uni != 0.f ? inter / uni : 0.f;
      if (iou > nms_threshold) alive[j] = 0;
    }
  }
  return kept;
}

// Batched variant: `offsets` has n_queries+1 entries delimiting each query's
// rows in `preds`. Output rows land at query q's slice of `out`
// (q * max_after * 3); `n_kept[q]` receives the per-query count.
void temporal_nms_batch(const float* preds, const int64_t* offsets,
                        int n_queries, float nms_threshold, int max_after,
                        float* out, int* n_kept) {
  for (int q = 0; q < n_queries; ++q) {
    const int64_t begin = offsets[q];
    const int n = static_cast<int>(offsets[q + 1] - begin);
    n_kept[q] = temporal_nms(preds + begin * 3, n, nms_threshold, max_after,
                             out + static_cast<int64_t>(q) * max_after * 3);
  }
}

}  // extern "C"
