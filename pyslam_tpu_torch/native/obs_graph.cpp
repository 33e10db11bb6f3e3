// Native observation graph + covisibility counting + SIMD Hamming (the
// port's own copy of the JAX package's native/obs_graph.cpp, same code and
// C ABI).
//
// The host-side bookkeeping the reference implements in its C++ core
// (pySLAM pyslam/slam/cpp/map.cpp observation maps and
// keyframe.cpp::update_connections, and cpp/hamming/hamming_module.cpp).
// The map mirrors its observation dicts here; the iteration order of these
// libstdc++ unordered_maps sets the order of the BA edge lists and of the
// covisibility counter, so the containers must stay as they are.
//
// Exposed as a plain C ABI consumed through ctypes.  The graph is an opaque
// handle:
//   og_create / og_destroy
//   og_add_observation(pid, kid, kp_idx)      -> 1 if newly added
//   og_remove_observation(pid, kid)           -> kp_idx or -1
//   og_remove_point(pid)
//   og_num_obs(pid)
//   og_point_obs(pid, out_kids, out_idxs, cap) -> count
//   og_covisibility_counts(pids, n, exclude_kid, out_kids, out_counts, cap)
//       -> number of distinct keyframes sharing those points (the hot loop of
//          update_connections)
//   og_points_seen_by(kid, out_pids, cap)
//   og_collect_observations(pids, n, out_pid_row, out_kid, out_kp, cap)
//   og_total_observations()
//   hamming_distance_matrix_u8(a, b, out, n, m, nbytes)
// Every function that fills a buffer stops at ``cap`` entries; the Python
// wrapper (native/__init__.py) sizes its buffers so that it never does.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct ObsGraph {
  // pid -> (kid -> kp_idx)
  std::unordered_map<int64_t, std::unordered_map<int32_t, int32_t>> obs;
  // kid -> set of pids (as a map for O(1) erase)
  std::unordered_map<int32_t, std::unordered_map<int64_t, char>> by_kf;
};

}  // namespace

extern "C" {

void* og_create() { return new ObsGraph(); }

void og_destroy(void* h) { delete static_cast<ObsGraph*>(h); }

int32_t og_add_observation(void* h, int64_t pid, int32_t kid, int32_t kp_idx) {
  auto* g = static_cast<ObsGraph*>(h);
  auto& m = g->obs[pid];
  auto it = m.find(kid);
  if (it != m.end()) return 0;
  m.emplace(kid, kp_idx);
  g->by_kf[kid].emplace(pid, 1);
  return 1;
}

int32_t og_remove_observation(void* h, int64_t pid, int32_t kid) {
  auto* g = static_cast<ObsGraph*>(h);
  auto pit = g->obs.find(pid);
  if (pit == g->obs.end()) return -1;
  auto it = pit->second.find(kid);
  if (it == pit->second.end()) return -1;
  int32_t kp = it->second;
  pit->second.erase(it);
  if (pit->second.empty()) g->obs.erase(pit);
  auto kit = g->by_kf.find(kid);
  if (kit != g->by_kf.end()) kit->second.erase(pid);
  return kp;
}

void og_remove_point(void* h, int64_t pid) {
  auto* g = static_cast<ObsGraph*>(h);
  auto pit = g->obs.find(pid);
  if (pit == g->obs.end()) return;
  for (auto& kv : pit->second) {
    auto kit = g->by_kf.find(kv.first);
    if (kit != g->by_kf.end()) kit->second.erase(pid);
  }
  g->obs.erase(pit);
}

int32_t og_num_obs(void* h, int64_t pid) {
  auto* g = static_cast<ObsGraph*>(h);
  auto pit = g->obs.find(pid);
  return pit == g->obs.end() ? 0 : (int32_t)pit->second.size();
}

int32_t og_point_obs(void* h, int64_t pid, int32_t* out_kids,
                     int32_t* out_idxs, int32_t cap) {
  auto* g = static_cast<ObsGraph*>(h);
  auto pit = g->obs.find(pid);
  if (pit == g->obs.end()) return 0;
  int32_t n = 0;
  for (auto& kv : pit->second) {
    if (n >= cap) break;
    out_kids[n] = kv.first;
    out_idxs[n] = kv.second;
    ++n;
  }
  return n;
}

int32_t og_covisibility_counts(void* h, const int64_t* pids, int32_t n,
                               int32_t exclude_kid, int32_t* out_kids,
                               int32_t* out_counts, int32_t cap) {
  auto* g = static_cast<ObsGraph*>(h);
  std::unordered_map<int32_t, int32_t> counter;
  counter.reserve(256);
  for (int32_t i = 0; i < n; ++i) {
    auto pit = g->obs.find(pids[i]);
    if (pit == g->obs.end()) continue;
    for (auto& kv : pit->second) {
      if (kv.first != exclude_kid) ++counter[kv.first];
    }
  }
  int32_t m = 0;
  for (auto& kv : counter) {
    if (m >= cap) break;
    out_kids[m] = kv.first;
    out_counts[m] = kv.second;
    ++m;
  }
  return m;
}

int32_t og_points_seen_by(void* h, int32_t kid, int64_t* out_pids,
                          int32_t cap) {
  auto* g = static_cast<ObsGraph*>(h);
  auto kit = g->by_kf.find(kid);
  if (kit == g->by_kf.end()) return 0;
  int32_t n = 0;
  for (auto& kv : kit->second) {
    if (n >= cap) break;
    out_pids[n] = kv.first;
    ++n;
  }
  return n;
}

int64_t og_collect_observations(void* h, const int64_t* pids, int32_t n,
                                int64_t* out_pid_row, int32_t* out_kid,
                                int32_t* out_kp, int64_t cap) {
  // Bulk edge dump for BA problem assembly (the reference builds this edge
  // list in C++ too, optimizer_g2o.cpp): for each input point row i, emit
  // (i, kid, kp_idx) for every observation.  One pass, no Python loop.
  auto* g = static_cast<ObsGraph*>(h);
  int64_t m = 0;
  for (int32_t i = 0; i < n; ++i) {
    auto pit = g->obs.find(pids[i]);
    if (pit == g->obs.end()) continue;
    for (auto& kv : pit->second) {
      if (m >= cap) return m;
      out_pid_row[m] = i;
      out_kid[m] = kv.first;
      out_kp[m] = kv.second;
      ++m;
    }
  }
  return m;
}

int64_t og_total_observations(void* h) {
  auto* g = static_cast<ObsGraph*>(h);
  int64_t t = 0;
  for (auto& kv : g->obs) t += (int64_t)kv.second.size();
  return t;
}

// ------------------------------------------------------- SIMD Hamming
// CPU twin of ops/hamming.py::hamming_distance_matrix (reference cpp/hamming):
// packed uint8 descriptors, popcount over XOR.
void hamming_distance_matrix_u8(const uint8_t* a, const uint8_t* b,
                                int32_t* out, int32_t n, int32_t m,
                                int32_t nbytes) {
  for (int32_t i = 0; i < n; ++i) {
    const uint8_t* ai = a + (int64_t)i * nbytes;
    for (int32_t j = 0; j < m; ++j) {
      const uint8_t* bj = b + (int64_t)j * nbytes;
      int32_t acc = 0;
      int32_t k = 0;
      for (; k + 8 <= nbytes; k += 8) {
        uint64_t x, y;
        std::memcpy(&x, ai + k, 8);
        std::memcpy(&y, bj + k, 8);
        acc += __builtin_popcountll(x ^ y);
      }
      for (; k < nbytes; ++k) acc += __builtin_popcount((uint32_t)(ai[k] ^ bj[k]));
      out[(int64_t)i * m + j] = acc;
    }
  }
}

}  // extern "C"
