// Host-side graph kernels of cnn_graph_tpu_torch: the port's own copy of
// cnn_graph_tpu/native/graph_kernels.cpp (the port imports nothing of the
// JAX package).
//
//   * graclus_one_level: one level of randomized heavy-edge matching over a
//     CSR graph, the sequential inner loop of multilevel Graclus coarsening.
//     Its plain Python version is graphs/coarsening.py graclus_pairing,
//     which gives the same clusters: the same visit order, the same gain
//     w_ij (1/d_i + 1/d_j) in double precision, the same strict ">" that
//     keeps the first of tied neighbours.  O(nnz) per level, but
//     latency-bound in Python on graphs of millions of edges.
//
// Built by cnn_graph_tpu_torch/_build.py (g++ -O3 -shared -fPIC, no
// -march=native and no fast math, so the gains round as Python's do) and
// bound with ctypes in cnn_graph_tpu_torch/native/__init__.py.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy Graclus matching.  Inputs: CSR (indptr[n+1], indices[nnz],
// data[nnz]), visit order rid[n], pairing weights w[n].  Output:
// cluster[n].  Returns the number of clusters.
int64_t graclus_one_level(const int64_t* indptr, const int32_t* indices,
                          const double* data, const int64_t* rid,
                          const double* weights, int64_t n,
                          int32_t* cluster) {
  std::vector<char> matched(static_cast<size_t>(n), 0);
  int64_t n_clusters = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t tid = rid[i];
    if (matched[tid]) continue;
    matched[tid] = 1;
    double best_gain = 0.0;
    int64_t best = -1;
    const double wt = 1.0 / weights[tid];
    for (int64_t e = indptr[tid]; e < indptr[tid + 1]; ++e) {
      const int32_t nid = indices[e];
      if (matched[nid]) continue;
      const double gain = data[e] * (wt + 1.0 / weights[nid]);
      if (gain > best_gain) {
        best_gain = gain;
        best = nid;
      }
    }
    cluster[tid] = static_cast<int32_t>(n_clusters);
    if (best >= 0) {
      cluster[best] = static_cast<int32_t>(n_clusters);
      matched[best] = 1;
    }
    ++n_clusters;
  }
  return n_clusters;
}

}  // extern "C"
