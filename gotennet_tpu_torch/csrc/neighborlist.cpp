// Radius graph of one molecule on the host, by a cell list.
//
// The loaders build every frame's neighbour list on the host while they
// collate a request.  numpy's all-pairs version (graph/neighborlist.py,
// ``build_edges_np``) is O(N^2) in time and memory, which paces a request of
// 10^3-10^4-atom frames; this cell list visits only the 27 cells around each
// centre.  Host code, not a GPU kernel: ``graph/native.py`` builds it with
// g++ at first use and binds the C function below with ctypes.
//
// The result is ``build_edges_np``'s, array for array and in the same order:
//  - an edge j -> i for every j != i with float32 distance
//    sqrtf(dx*dx + dy*dy + dz*dz) < cutoff, the components pos[j] - pos[i]
//    and the sum taken left to right, as numpy forms them (the build turns
//    off FMA contraction so that every product is rounded);
//  - with more than ``max_neighbors`` such j, the nearest ones by that
//    float32 distance, ties going to the lower index (numpy's stable
//    argsort);
//  - each centre's sources in increasing j, then its self-loop when
//    ``include_loops``; centres in increasing i.
// Comparing the distance itself, not its square against cutoff^2, keeps the
// cut and the tie-breaking where numpy puts them.
//
// Cells are a little wider than the cutoff, so that rounding in a cell index
// can never put two atoms closer than the cutoff two cells apart.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

// pos: [n, 3] float32; out_src, out_dst: int32 buffers of ``capacity``
// entries.  Returns the number of edges written, or -1 when they do not fit.
int64_t build_radius_graph(const float* pos, int64_t n, float cutoff,
                           int32_t max_neighbors, int32_t include_loops,
                           int32_t* out_src, int32_t* out_dst,
                           int64_t capacity) {
  if (n <= 0) return 0;
  float lo[3] = {pos[0], pos[1], pos[2]};
  float hi[3] = {pos[0], pos[1], pos[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pos[i * 3 + d]);
      hi[d] = std::max(hi[d], pos[i * 3 + d]);
    }
  }
  const float side = cutoff * 1.001f;
  const float inv = 1.0f / side;
  int32_t dims[3];
  for (int d = 0; d < 3; ++d) {
    // at most 64 cells an axis; the last one takes whatever lies beyond
    const float extent = std::floor((hi[d] - lo[d]) * inv) + 1.0f;
    dims[d] = static_cast<int32_t>(std::min(std::max(extent, 1.0f), 64.0f));
  }
  auto cell_of = [&](int64_t i, int32_t* c) {
    for (int d = 0; d < 3; ++d) {
      const int32_t v = static_cast<int32_t>((pos[i * 3 + d] - lo[d]) * inv);
      c[d] = std::min(std::max(v, 0), dims[d] - 1);
    }
  };
  auto flat = [&](int32_t x, int32_t y, int32_t z) {
    return (static_cast<size_t>(x) * dims[1] + y) * dims[2] + z;
  };
  // atoms by cell, each cell's atoms in increasing index (a counting sort)
  const size_t n_cells = static_cast<size_t>(dims[0]) * dims[1] * dims[2];
  std::vector<int64_t> start(n_cells + 1, 0);
  std::vector<int32_t> cell(n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t c[3];
    cell_of(i, c);
    cell[i] = static_cast<int32_t>(flat(c[0], c[1], c[2]));
    ++start[cell[i] + 1];
  }
  for (size_t c = 0; c < n_cells; ++c) start[c + 1] += start[c];
  std::vector<int32_t> atoms(n);
  {
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      atoms[fill[cell[i]]++] = static_cast<int32_t>(i);
  }

  int64_t e = 0;
  std::vector<std::pair<float, int32_t>> nbrs;   // (distance, source)
  nbrs.reserve(256);
  for (int64_t i = 0; i < n; ++i) {
    nbrs.clear();
    int32_t c[3];
    cell_of(i, c);
    const float xi = pos[i * 3], yi = pos[i * 3 + 1], zi = pos[i * 3 + 2];
    for (int32_t x = std::max(c[0] - 1, 0);
         x <= std::min(c[0] + 1, dims[0] - 1); ++x) {
      for (int32_t y = std::max(c[1] - 1, 0);
           y <= std::min(c[1] + 1, dims[1] - 1); ++y) {
        for (int32_t z = std::max(c[2] - 1, 0);
             z <= std::min(c[2] + 1, dims[2] - 1); ++z) {
          const size_t f = flat(x, y, z);
          for (int64_t a = start[f]; a < start[f + 1]; ++a) {
            const int32_t j = atoms[a];
            if (j == i) continue;
            const float dx = pos[j * 3] - xi;
            const float dy = pos[j * 3 + 1] - yi;
            const float dz = pos[j * 3 + 2] - zi;
            const float d2 = dx * dx + dy * dy + dz * dz;
            const float dist = std::sqrt(d2);
            if (dist < cutoff) nbrs.emplace_back(dist, j);
          }
        }
      }
    }
    if (static_cast<int64_t>(nbrs.size()) > max_neighbors) {
      // (distance, index) order: the nearest, ties to the lower index
      std::nth_element(nbrs.begin(), nbrs.begin() + max_neighbors,
                       nbrs.end());
      nbrs.resize(max_neighbors);
    }
    std::sort(nbrs.begin(), nbrs.end(), [](const auto& a, const auto& b) {
      return a.second < b.second;
    });
    const int64_t need =
        static_cast<int64_t>(nbrs.size()) + (include_loops ? 1 : 0);
    if (e + need > capacity) return -1;
    for (const auto& p : nbrs) {
      out_src[e] = p.second;
      out_dst[e] = static_cast<int32_t>(i);
      ++e;
    }
    if (include_loops) {
      out_src[e] = static_cast<int32_t>(i);
      out_dst[e] = static_cast<int32_t>(i);
      ++e;
    }
  }
  return e;
}

}  // extern "C"
