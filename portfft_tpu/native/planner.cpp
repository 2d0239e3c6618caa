// Native planner core — C++ implementation of the commit-time planning
// primitives (the reference's planner is likewise native host code:
// committed_descriptor_impl.hpp prepare_implementation :211-313 and the
// factorization helpers utils.hpp:94-132, workitem.hpp:136-144).
//
// Exposed through a C ABI for ctypes (no pybind11 in this image).  The
// Python planner (portfft_tpu/planner.py) keeps a pure-Python fallback and
// verifies parity in tests.
//
// Build: g++ -O2 -shared -fPIC -o libpfftplan.so planner.cpp

#include <cstdint>

extern "C" {

// ---------------------------------------------------------------------------
// Prime factorization (ascending).  Returns count, or -1 if out of capacity.
// ---------------------------------------------------------------------------
int pf_prime_factorize(int64_t n, int64_t* out, int cap) {
  int cnt = 0;
  for (int64_t d = 2; d * d <= n;) {
    while (n % d == 0) {
      if (cnt >= cap) return -1;
      out[cnt++] = d;
      n /= d;
    }
    d += (d == 2) ? 1 : 2;
  }
  if (n > 1) {
    if (cnt >= cap) return -1;
    out[cnt++] = n;
  }
  return cnt;
}

int64_t pf_largest_prime_factor(int64_t n) {
  int64_t last = 1;
  for (int64_t d = 2; d * d <= n;) {
    while (n % d == 0) {
      last = d;
      n /= d;
    }
    d += (d == 2) ? 1 : 2;
  }
  return n > 1 ? n : last;
}

// ---------------------------------------------------------------------------
// Factor chain: split n into factors <= max_factor, greedily largest-first
// (largest matmul stages; fewest passes).  Returns count, 0 when a
// prime factor exceeds max_factor (Bluestein), -1 on capacity overflow.
// ---------------------------------------------------------------------------
int pf_factor_chain(int64_t n, int max_factor, int64_t* out, int cap) {
  if (n == 1) {
    if (cap < 1) return -1;
    out[0] = 1;
    return 1;
  }
  if (pf_largest_prime_factor(n) > max_factor) return 0;
  int cnt = 0;
  int64_t rest = n;
  while (rest > 1) {
    int64_t f = 0;
    int64_t start = rest < max_factor ? rest : max_factor;
    for (int64_t cand = start; cand > 1; --cand) {
      if (rest % cand == 0) {
        f = cand;
        break;
      }
    }
    if (cnt >= cap) return -1;
    out[cnt++] = f;
    rest /= f;
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// FUSED-chain working-set estimate (mirrors planner.fused_working_set_bytes:
// double-buffered in/out planes, ping-pong scratch, tables once).
// ---------------------------------------------------------------------------
static int64_t fused_working_set_bytes(int64_t n, const int64_t* factors,
                                       int nfac, int64_t rows,
                                       int64_t itemsize) {
  int64_t data = rows * n * itemsize;
  int64_t in_out = 2 * (2 * data) * 2;
  int64_t scratch = 2 * (2 * data);
  // unique factor table bytes
  int64_t tables = 0;
  for (int i = 0; i < nfac; ++i) {
    bool seen = false;
    for (int j = 0; j < i; ++j)
      if (factors[j] == factors[i]) {
        seen = true;
        break;
      }
    if (!seen) tables += 2 * factors[i] * factors[i] * itemsize;
  }
  // inter-factor twiddles: stage i has (f_i, m_i), m_i = prod(f_{i+1..})
  int64_t tw = 0;
  int64_t m = n;
  for (int i = 0; i < nfac; ++i) {
    m /= factors[i];
    if (m > 1) tw += 2 * factors[i] * m * itemsize;
  }
  return in_out + scratch + tables + tw;
}

// ---------------------------------------------------------------------------
// Balanced four-step split n = g1*g2 with both halves plannable at DIRECT or
// FUSED level (reference global factorization analogue,
// committed_descriptor_impl.hpp:271-312).  Writes g1, g2; returns 1 on
// success, 0 when no split exists.
// ---------------------------------------------------------------------------
static int side_ok(int64_t v, int max_factor, int64_t direct_threshold,
                   int64_t fused_rows, int64_t itemsize,
                   int64_t fused_budget) {
  int64_t chain[64];
  int cnt = pf_factor_chain(v, max_factor, chain, 64);
  if (cnt <= 0) return 0;
  if (v <= direct_threshold) return 1;
  return fused_working_set_bytes(v, chain, cnt, fused_rows, itemsize) <=
         fused_budget;
}

// Preference order (mirrors planner.py _global_split):
//   1. both halves DIRECT (<= direct_threshold, 8-aligned), balanced;
//   2. G1 = a*128 two-stage FUSED (a | 128) with G2 DIRECT, minimizing the
//      matmul work (a + 128 + G2), pass-1 working set bounded by
//      pass_budget;
//   3. legacy balanced search over anything plannable.
int pf_global_split(int64_t n, int max_factor, int64_t direct_threshold,
                    int64_t fused_rows, int64_t itemsize,
                    int64_t fused_budget, int64_t pass_budget,
                    int64_t* g1_out, int64_t* g2_out) {
  int64_t root = 1;
  while ((root + 1) * (root + 1) <= n) ++root;
  // 1) both-direct balanced
  for (int64_t g1 = root; g1 > 1; --g1) {
    if (n % g1) continue;
    int64_t g2 = n / g1;
    if (g2 <= direct_threshold && g1 <= direct_threshold && g2 % 8 == 0 &&
        g1 % 8 == 0) {
      *g1_out = g2;
      *g2_out = g1;
      return 1;
    }
  }
  // 2) one-fused: G1 = a*128, G2 direct, cheapest matmul work first
  int64_t best_cost = -1, best_g1 = 0, best_g2 = 0;
  for (int64_t a = 8; a <= 128; a *= 2) {
    int64_t g1 = a * 128;
    if (n % g1) continue;
    int64_t g2 = n / g1;
    if (g2 <= 1 || g2 > direct_threshold || g2 % 8) continue;
    if (18 * 64 * g1 * itemsize + 2 * 128 * a * 128 * itemsize > pass_budget)
      continue;
    int64_t cost = a + 128 + g2;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_g1 = g1;
      best_g2 = g2;
    }
  }
  if (best_cost >= 0) {
    *g1_out = best_g1;
    *g2_out = best_g2;
    return 1;
  }
  // 3) legacy balanced search
  for (int64_t g1 = root; g1 > 1; --g1) {
    if (n % g1) continue;
    int64_t g2 = n / g1;
    if (side_ok(g2, max_factor, direct_threshold, fused_rows, itemsize,
                fused_budget) &&
        side_ok(g1, max_factor, direct_threshold, fused_rows, itemsize,
                fused_budget)) {
      *g1_out = g2;
      *g2_out = g1;
      return 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// 1D batch-overlap validation (reference descriptor_validation.hpp:162-204):
// modular-arithmetic walk over batch start indices.  Returns the colliding
// batch index, or -1 when there is no collision.
// ---------------------------------------------------------------------------
int64_t pf_overlap_check_1d(int64_t fft_size, int64_t batch, int64_t stride,
                            int64_t distance) {
  int64_t first_batch_limit = stride * fft_size;
  int64_t first_length_limit = distance * batch;
  if ((stride <= distance && first_batch_limit <= distance) ||
      (distance <= stride && first_length_limit <= stride))
    return -1;
  for (int64_t b = 1; b < batch;) {
    int64_t first = b * distance;
    int64_t column = first % stride;
    if (column == 0) {
      if (first >= first_batch_limit) return -1;
      return b;
    }
    int64_t skip = (stride - column) / distance;
    if ((stride - column) % distance) ++skip;
    b += skip;
  }
  return -1;
}

}  // extern "C"
