// Skyline memory planner + lifetime overlap checker.
//
// Counterpart of the reference's C++ memory machinery: the profiling
// allocator's planned-address replay (easydist/torch/profiler/csrc/
// profiling_allocator.cpp) and the EfficientMemoryScheduler's skyline
// address assignment (torch/schedule/efficient_memory_scheduler.py:32-120).
// The planner's role is *analysis*: given buffer lifetimes+sizes (from the
// MetaGraph's liveness under the solved placements), compute a
// fragmentation-aware peak and offsets, and verify lifetime disjointness
// (the op_mem_checker analog, compile_auto.py:269-351).
//
// C ABI, bound from Python with ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Buf {
  int64_t start, end, size;  // live over [start, end] inclusive
  int64_t idx;
};

}  // namespace

extern "C" {

// Greedy best-fit skyline: buffers sorted by size descending are placed at
// the lowest offset where they do not overlap (in time AND address) any
// already-placed buffer.  Writes per-buffer offsets; returns peak bytes.
int64_t ed_skyline_plan(int64_t n, const int64_t* starts, const int64_t* ends,
                        const int64_t* sizes, int64_t* offsets_out) {
  std::vector<Buf> bufs(n);
  for (int64_t i = 0; i < n; ++i) bufs[i] = {starts[i], ends[i], sizes[i], i};
  std::stable_sort(bufs.begin(), bufs.end(), [](const Buf& a, const Buf& b) {
    if (a.size != b.size) return a.size > b.size;
    return a.start < b.start;
  });

  struct Placed {
    int64_t start, end, off, size;
  };
  std::vector<Placed> placed;
  placed.reserve(n);
  int64_t peak = 0;

  std::vector<std::pair<int64_t, int64_t>> blocked;  // addr ranges in conflict
  for (const Buf& b : bufs) {
    blocked.clear();
    for (const Placed& p : placed) {
      if (p.start <= b.end && b.start <= p.end) {
        blocked.emplace_back(p.off, p.off + p.size);
      }
    }
    std::sort(blocked.begin(), blocked.end());
    int64_t off = 0;
    for (const auto& [lo, hi] : blocked) {
      if (off + b.size <= lo) break;  // fits in the gap before this range
      if (off < hi) off = hi;
    }
    placed.push_back({b.start, b.end, off, b.size});
    offsets_out[b.idx] = off;
    peak = std::max(peak, off + b.size);
  }
  return peak;
}

// Lifetime-overlap verification: returns the number of pairs of buffers
// whose address ranges overlap while both are live (0 = plan is valid).
// First `max_report` offending pairs are written to report_out (i, j).
int64_t ed_check_plan(int64_t n, const int64_t* starts, const int64_t* ends,
                      const int64_t* sizes, const int64_t* offsets,
                      int64_t max_report, int64_t* report_out) {
  int64_t violations = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = i + 1; j < n; ++j) {
      const bool time_overlap = starts[i] <= ends[j] && starts[j] <= ends[i];
      if (!time_overlap) continue;
      const bool addr_overlap = offsets[i] < offsets[j] + sizes[j] &&
                                offsets[j] < offsets[i] + sizes[i];
      if (addr_overlap) {
        if (violations < max_report) {
          report_out[2 * violations] = i;
          report_out[2 * violations + 1] = j;
        }
        ++violations;
      }
    }
  }
  return violations;
}

// Peak live bytes without packing (sum of live sizes per tick) — the
// lower bound any allocator can reach.
int64_t ed_peak_live(int64_t n, const int64_t* starts, const int64_t* ends,
                     const int64_t* sizes) {
  if (n == 0) return 0;
  int64_t max_t = 0;
  for (int64_t i = 0; i < n; ++i) max_t = std::max(max_t, ends[i]);
  std::vector<int64_t> delta(static_cast<size_t>(max_t) + 2, 0);
  for (int64_t i = 0; i < n; ++i) {
    delta[starts[i]] += sizes[i];
    delta[ends[i] + 1] -= sizes[i];
  }
  int64_t cur = 0, peak = 0;
  for (int64_t t = 0; t <= max_t; ++t) {
    cur += delta[t];
    peak = std::max(peak, cur);
  }
  return peak;
}

}  // extern "C"
