// Beam-search strategy solver core.
//
// The compile-time hot loop of strategy selection (the Python fallback in
// autoflow/solver.py beam_search; reference formulation autoflow/
// solver.py:814-890).  For large graphs (thousands of clusters) the Python
// loop dominates compile time; this C++ core runs the identical algorithm
// over flattened cost matrices, ties included (a stable sort of each
// cluster's candidates), so it returns what the Python loop returns.
//
// Inputs (flattened, C ABI):
//   n_clusters, strat_count[c]
//   y_cost: per-cluster linear costs, laid out cluster-major
//           (offset y_off[c], length strat_count[c])
//   n_edges, edge_up[e], edge_down[e]: cluster ids
//   edge_cost: matrices laid out edge-major (offset e_off[e],
//              row-major [strat_count[up] x strat_count[down]])
//   beam_width
// Output: chosen strategy index per cluster; returns best cost.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Candidate {
  double cost;
  std::vector<int32_t> assign;  // strategy per cluster processed so far
};

}  // namespace

extern "C" {

double ed_beam_search(int64_t n_clusters, const int64_t* strat_count,
                      const double* y_cost, const int64_t* y_off,
                      int64_t n_edges, const int64_t* edge_up,
                      const int64_t* edge_down, const double* edge_cost,
                      const int64_t* e_off, int64_t beam_width,
                      int32_t* assign_out) {
  // index edges by endpoint for incremental cost evaluation
  std::vector<std::vector<int64_t>> in_edges(n_clusters), out_edges(n_clusters);
  for (int64_t e = 0; e < n_edges; ++e) {
    in_edges[edge_down[e]].push_back(e);
    out_edges[edge_up[e]].push_back(e);
  }

  std::vector<Candidate> beam(1);
  beam[0].cost = 0.0;

  for (int64_t c = 0; c < n_clusters; ++c) {
    std::vector<Candidate> grown;
    grown.reserve(beam.size() * strat_count[c]);
    for (const Candidate& cand : beam) {
      for (int32_t s = 0; s < strat_count[c]; ++s) {
        double delta = y_cost[y_off[c] + s];
        // edge charged when its SECOND endpoint is assigned
        for (int64_t e : in_edges[c]) {
          const int64_t up = edge_up[e];
          if (up < c) {
            const int64_t n_down = strat_count[c];
            delta += edge_cost[e_off[e] + cand.assign[up] * n_down + s];
          }
        }
        for (int64_t e : out_edges[c]) {
          const int64_t down = edge_down[e];
          if (down < c) {
            const int64_t n_down = strat_count[down];
            delta += edge_cost[e_off[e] + s * n_down + cand.assign[down]];
          }
        }
        grown.push_back(cand);
        grown.back().cost += delta;
        grown.back().assign.push_back(s);
      }
    }
    // stable: among equal costs the earlier candidate stays, as in the
    // Python loop's list.sort, so both keep the same beam (std::partial_sort
    // may keep another of the tied candidates and end on another solution)
    const size_t keep = std::min<size_t>(grown.size(),
                                         static_cast<size_t>(beam_width));
    std::stable_sort(grown.begin(), grown.end(),
                     [](const Candidate& a, const Candidate& b) {
                       return a.cost < b.cost;
                     });
    grown.resize(keep);
    beam.swap(grown);
  }

  const Candidate& best = beam.front();
  std::memcpy(assign_out, best.assign.data(),
              sizeof(int32_t) * static_cast<size_t>(n_clusters));
  return best.cost;
}

}  // extern "C"
