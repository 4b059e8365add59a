// Native A* path planner over heightfield grids.
//
// C++ equivalent of the pure-Python planner in parc_torch/procgen/astar.py
// (reference semantics: tools/procgen/astar.py:8-507): 8-connected walk
// edges gated by max step height, straight-line jump edges across
// gaps/cliffs, costs = distance + weighted |dz| + bumpiness + uniform random
// tie-breaker. The source is the JAX package's planner unchanged, built with
// the same flags, so one seed gives one path in both packages.
//
// Kin-gen runs one search per generated motion on the host. Built with g++
// at first use and loaded via its C ABI with ctypes (procgen/astar.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Settings {
  float max_z_diff;
  float max_jump_dist;
  float min_jump_gap;
  float z_weight;
  float bumpiness_weight;
  float rand_cost_scale;
  float jump_cost_mult;
};

struct Node {
  float f;
  float g;
  int32_t idx;      // i * w + j
  int32_t parent;   // flat index or -1
  int32_t is_jump;
};

struct NodeCmp {
  bool operator()(const Node& a, const Node& b) const { return a.f > b.f; }
};

struct Jump {
  int di, dj, ncells;
};

std::vector<Jump> jump_candidates(float dx, const Settings& s) {
  const int max_cells = static_cast<int>(s.max_jump_dist / dx);
  const int min_cells = std::max(static_cast<int>(s.min_jump_gap / dx), 2);
  static const int dirs[8][2] = {{1, 0},  {-1, 0}, {0, 1},  {0, -1},
                                 {1, 1},  {1, -1}, {-1, 1}, {-1, -1}};
  std::vector<Jump> out;
  for (const auto& d : dirs) {
    const float step = std::hypot(static_cast<float>(d[0]),
                                  static_cast<float>(d[1])) * dx;
    for (int n = min_cells; n <= max_cells; ++n) {
      if (n * step <= s.max_jump_dist) out.push_back({d[0] * n, d[1] * n, n});
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Plans start->goal on an h*w row-major heightfield.
// out_path: caller-allocated (h*w*3) int32 buffer receiving
// [i, j, jump_flag] rows. Returns path length, 0 if unreachable,
// -1 on bad arguments.
int32_t parc_astar(const float* hf, int32_t h, int32_t w, float dx, float dy,
                   int32_t start_i, int32_t start_j, int32_t goal_i,
                   int32_t goal_j, const Settings* settings, uint64_t seed,
                   int32_t* out_path) {
  if (!hf || !settings || !out_path || h <= 0 || w <= 0) return -1;
  if (start_i < 0 || start_i >= h || start_j < 0 || start_j >= w ||
      goal_i < 0 || goal_i >= h || goal_j < 0 || goal_j >= w)
    return -1;
  const Settings s = *settings;
  const int32_t n = h * w;
  const int32_t start = start_i * w + start_j;
  const int32_t goal = goal_i * w + goal_j;

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);

  const auto jumps = jump_candidates(dx, s);

  auto heuristic = [&](int32_t i, int32_t j) {
    return std::hypot((i - goal_i) * dx, (j - goal_j) * dy);
  };

  std::vector<float> g_score(n, std::numeric_limits<float>::infinity());
  std::vector<int32_t> came_from(n, -2);  // -2 unset, -1 root
  std::vector<uint8_t> jump_flag(n, 0);
  std::vector<uint8_t> closed(n, 0);
  std::priority_queue<Node, std::vector<Node>, NodeCmp> open;

  g_score[start] = 0.0f;
  open.push({heuristic(start_i, start_j), 0.0f, start, -1, 0});

  while (!open.empty()) {
    const Node cur = open.top();
    open.pop();
    if (closed[cur.idx]) continue;
    closed[cur.idx] = 1;
    came_from[cur.idx] = cur.parent;
    jump_flag[cur.idx] = static_cast<uint8_t>(cur.is_jump);

    if (cur.idx == goal) {
      // reconstruct (reversed), then flip
      std::vector<int32_t> rev;
      for (int32_t c = cur.idx; c != -1; c = came_from[c]) rev.push_back(c);
      const int32_t len = static_cast<int32_t>(rev.size());
      for (int32_t k = 0; k < len; ++k) {
        const int32_t c = rev[len - 1 - k];
        out_path[3 * k + 0] = c / w;
        out_path[3 * k + 1] = c % w;
        out_path[3 * k + 2] = jump_flag[c];
      }
      return len;
    }

    const int32_t i = cur.idx / w, j = cur.idx % w;
    const float z = hf[cur.idx];

    // walk edges
    for (int di = -1; di <= 1; ++di) {
      for (int dj = -1; dj <= 1; ++dj) {
        if (di == 0 && dj == 0) continue;
        const int32_t ni = i + di, nj = j + dj;
        if (ni < 0 || ni >= h || nj < 0 || nj >= w) continue;
        const float dz = hf[ni * w + nj] - z;
        if (std::fabs(dz) > s.max_z_diff) continue;
        const float dist = std::hypot(di * dx, dj * dy);
        // local bumpiness around the target cell
        float pmin = std::numeric_limits<float>::infinity();
        float pmax = -pmin;
        for (int pi = std::max(ni - 1, 0); pi < std::min(ni + 2, h); ++pi)
          for (int pj = std::max(nj - 1, 0); pj < std::min(nj + 2, w); ++pj) {
            const float v = hf[pi * w + pj];
            pmin = std::min(pmin, v);
            pmax = std::max(pmax, v);
          }
        const float bump = pmax - pmin;
        const float cost = dist + s.z_weight * std::fabs(dz) +
                           s.bumpiness_weight * bump * dist +
                           s.rand_cost_scale * uni(rng);
        const float ng = cur.g + cost;
        const int32_t nxt = ni * w + nj;
        if (ng < g_score[nxt]) {
          g_score[nxt] = ng;
          open.push({ng + heuristic(ni, nj), ng, nxt, cur.idx, 0});
        }
      }
    }

    // jump edges: intermediate cells must be below both endpoints
    for (const auto& jp : jumps) {
      const int32_t ni = i + jp.di, nj = j + jp.dj;
      if (ni < 0 || ni >= h || nj < 0 || nj >= w) continue;
      const float zn = hf[ni * w + nj];
      const float dz = zn - z;
      if (dz > s.max_z_diff) continue;
      float mid_max = -std::numeric_limits<float>::infinity();
      for (int k = 1; k < jp.ncells; ++k) {
        const float t = static_cast<float>(k) / jp.ncells;
        const int32_t mi =
            static_cast<int32_t>(std::lround(i + t * jp.di));
        const int32_t mj =
            static_cast<int32_t>(std::lround(j + t * jp.dj));
        mid_max = std::max(mid_max, hf[mi * w + mj]);
      }
      if (jp.ncells > 1 && mid_max > std::min(z, zn) - 0.3f) continue;
      const float dist = std::hypot(jp.di * dx, jp.dj * dy);
      const float cost =
          s.jump_cost_mult *
          (dist + s.z_weight * std::fabs(dz) + s.rand_cost_scale * uni(rng));
      const float ng = cur.g + cost;
      const int32_t nxt = ni * w + nj;
      if (ng < g_score[nxt]) {
        g_score[nxt] = ng;
        open.push({ng + heuristic(ni, nj), ng, nxt, cur.idx, 1});
      }
    }
  }
  return 0;  // unreachable
}

}  // extern "C"
