// Native covisibility random-walk sampler of the port's data path.
//
// A copy of mapanything_tpu/native/covis_sampler.cpp: the connected-subgraph
// random walk over a scene's covisibility matrix (the reference's
// mapanything/datasets/base/base_dataset.py:316-454, pure Python over numpy
// mmaps). mapanything_tpu_torch/native/__init__.py builds it with g++ at first
// use into build/native/ and binds it with ctypes; a failed build raises.
//
// The RNG is a SplitMix64 seeded by the caller, so a seed gives the same walk
// here and in the JAX package's library (not numpy's Generator: the numpy walk
// of the datasets is another stream).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97f4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // Unbiased bounded draw (Lemire).
  uint32_t bounded(uint32_t n) {
    if (n == 0) return 0;
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    return (uint32_t)(m >> 32);
  }
};

}  // namespace

extern "C" {

// Random-walk connected-subgraph sampling with backtracking + retries.
//
// covis:        row-major n x n covisibility matrix (float32)
// n:            number of views in the scene
// thres:        covisibility threshold (relative to self-covisibility)
// num_samples:  desired number of sampled views
// max_retries:  restarts with unvisited components
// bidirectional: average covis[i][j] and covis[j][i] when walking
// seed:         RNG seed
// out_indices:  caller buffer of size >= num_samples
//
// Returns the number of indices written (== num_samples on success; fewer
// when the graph has no large-enough connected component — the caller
// resamples with replacement, matching the Python behavior).
int covis_random_walk(const float* covis, int n, float thres, int num_samples,
                      int max_retries, int bidirectional, uint64_t seed,
                      int* out_indices) {
  if (n <= 0 || num_samples <= 0) return 0;
  SplitMix64 rng(seed);

  std::vector<uint8_t> excluded(n, 0);
  std::vector<int> best_walk;
  std::vector<uint8_t> visited(n);
  std::vector<int> walk, stack, candidates, available;
  std::vector<float> row(n);

  for (int attempt = 0; attempt < max_retries; ++attempt) {
    std::fill(visited.begin(), visited.end(), 0);
    walk.clear();
    stack.clear();

    available.clear();
    for (int i = 0; i < n; ++i)
      if (!excluded[i]) available.push_back(i);
    if (available.empty()) break;

    int start = available[rng.bounded((uint32_t)available.size())];
    walk.push_back(start);
    visited[start] = 1;
    stack.push_back(start);

    while ((int)walk.size() < num_samples && !stack.empty()) {
      int cur = stack.back();
      const float* r = covis + (size_t)cur * n;
      float self_cov;
      if (bidirectional) {
        for (int j = 0; j < n; ++j)
          row[j] = 0.5f * (r[j] + covis[(size_t)j * n + cur]);
        self_cov = row[cur];
      } else {
        std::memcpy(row.data(), r, sizeof(float) * n);
        self_cov = r[cur];
      }
      float denom = self_cov + 1e-8f;

      candidates.clear();
      for (int j = 0; j < n; ++j) {
        if (j == cur || visited[j]) continue;
        if (row[j] / denom > thres) candidates.push_back(j);
      }
      if (!candidates.empty()) {
        int nxt = candidates[rng.bounded((uint32_t)candidates.size())];
        walk.push_back(nxt);
        visited[nxt] = 1;
        stack.push_back(nxt);
      } else {
        stack.pop_back();
      }
    }

    if (walk.size() > best_walk.size()) best_walk = walk;
    if ((int)walk.size() >= num_samples) break;
    for (int i = 0; i < n; ++i)
      if (visited[i]) excluded[i] = 1;
  }

  int count = (int)best_walk.size();
  if (count > num_samples) count = num_samples;
  std::memcpy(out_indices, best_walk.data(), sizeof(int) * count);
  return count;
}

}  // extern "C"
