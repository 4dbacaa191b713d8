// Pair reduction, hand-written for sm_90a: each particle's force and
// torque summed over its rows of the pair list, and the list's pe and
// virial, from the pair law's output rows.
//
// Replaces no TPU kernel: the reference sums the rows with
// jax.ops.segment_sum over sorted ids (spherharm_tpu/ops/contact.py
// contact_force_pairs, the acc_i / acc_j sums, pe_total and the virial
// einsum), which XLA fuses. The port's plain chain
// (contact_kernels.pair_reduce_plain: float64 prefix sums over every slot,
// differenced at searchsorted bounds, a permuted copy for the j side, a
// GEMM for the virial) is about twenty launches over all P slots.
//
// What bounds it on this card: bytes, and before them latency. A live
// slot needs its row's force, torque, torque_j, pe, d and mask (56 of the
// row's 96 bytes), pair_i, pair_j, its pair_jsort entry and pair_both;
// the outputs are 24 bytes a particle. Dead slots need nothing: a list's
// live slots are a prefix of it (build_pair_list and prefilter_pair_list
// compact the list, and tests/test_torch_contact_kernels.py and
// tests/test_torch_ranks.py hold both to it), a dead slot's row is zeros
// and its pair_i and pair_j are N - 1. The sheared cell's list
// is 1.2M slots with about 298k live. The design:
//   * one block of kThreads particles of one list (grid: particle blocks
//     x lists); four warps find, each by a 32-way search, the list's live
//     length L (the first slot with valid false) and then the block's
//     rows: [B0, B1) of pair_i over [0, L) and [C0, C1) of the j order
//     pair_j[pair_jsort[q]] over q in [0, L). pair_jsort is a stable sort
//     of pair_j, and the dead slots carry its largest key, so they are
//     its last P - L entries: q < L stops N - 1's segment at its first
//     dead slot, and the dead tail is neither read nor walked;
//   * the block scans its rows once, coalesced, and marks in shared
//     memory where each particle's segment starts (both sides); the i
//     scan also sums pe w and the nine w d (x) force products (w = 1
//     where the mask and pair_both hold, else 0.5) and counts masked rows;
//   * then each thread sums its particle's rows in list order in float64:
//     force and torque over its pair_i segment, -force and torque_j over
//     its j segment where the mask and pair_both hold; the two sides are
//     written as f32 and added in f32, as the plain chain adds them;
//   * pe, virial and the count leave the block as float64 partials
//     (a shuffle tree, then the warps in order), and a second launch of
//     one block a list sums them in a fixed order. No atomics: the blocks
//     depend on the list alone (its N, P and rows), so every call gives
//     the same bits and a list in an [R, P] stack gives its single
//     list's bits.
// Measured by chip_smoke.py (reduce cases) on an NVIDIA H100 80GB HBM3 at
// 700.00 W: PERF.md section 6.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // particles a block
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 24;   // floats of a law output row (contact_kernels.N_OUT)
constexpr int kSums = 10;  // pe w, then w d_a force_b at 1 + 3 a + b
constexpr unsigned kFull = 0xffffffffu;

// The first i in [lo, hi) with pred(i), or hi, where pred is false then
// true along the range: a warp's 32-way search, every lane returns it.
template <class Pred>
__device__ int warp_first(int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + (lane + 1) * step - 1;  // lane 31 probes hi - 1 or past it
    const unsigned hit = __ballot_sync(kFull, i >= hi || pred(i));
    if (!hit) return hi;
    const int k = __ffs(hit) - 1;
    hi = min(hi, lo + (k + 1) * step - 1);
    lo += k * step;
  }
  const int i = lo + lane;
  const unsigned hit = __ballot_sync(kFull, i < hi && pred(i));
  return hit ? lo + __ffs(hit) - 1 : hi;
}

__global__ void __launch_bounds__(kThreads)
pair_reduce_kernel(const float* __restrict__ out, const long long* __restrict__ pi,
                   const long long* __restrict__ pj, const long long* __restrict__ perm,
                   const unsigned char* __restrict__ both,
                   const unsigned char* __restrict__ valid, int N, int P,
                   float* __restrict__ f, float* __restrict__ tau,
                   double* __restrict__ part, int* __restrict__ part_n,
                   int* __restrict__ stats) {
  __shared__ int s_i[kThreads + 1];  // start of each particle's i rows, then B1
  __shared__ int s_j[kThreads + 1];  // the same of its j-order positions, then C1
  __shared__ int s_bounds[4];        // B0, B1, C0, C1
  __shared__ int s_live;
  __shared__ double s_sums[kWarps][kSums];
  __shared__ int s_n[kWarps];

  const int list = blockIdx.y;
  const size_t base = (size_t)list * P;
  out += base * kRow;
  pi += base;
  pj += base;
  perm += base;
  both += base;
  valid += base;
  const int n0 = blockIdx.x * kThreads;
  const int n1 = min(n0 + kThreads, N);
  const int t = threadIdx.x, warp = t >> 5;

  if (warp < 4) {
    const int L = warp_first(0, P, [&](int i) { return !valid[i]; });
    const int key = warp & 1 ? n1 : n0;
    int b = L;
    if (key < N) {
      b = warp < 2 ? warp_first(0, L, [&](int i) { return pi[i] >= key; })
                   : warp_first(0, L, [&](int q) { return pj[perm[q]] >= key; });
    }
    if ((t & 31) == 0) {
      s_bounds[warp] = b;
      if (warp == 0) s_live = L;
    }
  }
  __syncthreads();
  const int B0 = s_bounds[0], B1 = s_bounds[1], C0 = s_bounds[2], C1 = s_bounds[3];
  const int cnt = n1 - n0;
  for (int k = t; k <= cnt; k += kThreads) {
    s_i[k] = B1;
    s_j[k] = C1;
  }
  if (blockIdx.x == 0 && t == 0) stats[2 * list] = s_live;
  __syncthreads();

  double sums[kSums] = {};
  int masked = 0;
  for (int p = B0 + t; p < B1; p += kThreads) {
    const int cur = (int)pi[p];
    const int prev = p == B0 ? n0 - 1 : (int)pi[p - 1];
    for (int k = prev + 1; k <= cur; ++k) s_i[k - n0] = p;
    const float* r = out + (size_t)p * kRow;
    const bool m = r[20] > 0.5f;
    const double w = m && both[p] ? 1.0 : 0.5;
    masked += m;
    sums[0] += w * (double)r[15];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double wd = w * (double)r[17 + a];
#pragma unroll
      for (int b = 0; b < 3; ++b) sums[1 + 3 * a + b] += wd * (double)r[b];
    }
  }
  for (int q = C0 + t; q < C1; q += kThreads) {
    const int cur = (int)pj[perm[q]];
    const int prev = q == C0 ? n0 - 1 : (int)pj[perm[q - 1]];
    for (int k = prev + 1; k <= cur; ++k) s_j[k - n0] = q;
  }
  __syncthreads();

  if (t < cnt) {
    double fi[3] = {}, ti[3] = {}, fj[3] = {}, tj[3] = {};
    for (int p = s_i[t]; p < s_i[t + 1]; ++p) {
      const float* r = out + (size_t)p * kRow;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        fi[c] += (double)r[c];
        ti[c] += (double)r[3 + c];
      }
    }
    for (int q = s_j[t]; q < s_j[t + 1]; ++q) {
      const int p = (int)perm[q];
      const float* r = out + (size_t)p * kRow;
      if (r[20] > 0.5f && both[p]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          fj[c] -= (double)r[c];
          tj[c] += (double)r[6 + c];
        }
      }
    }
    const size_t n = (size_t)list * N + n0 + t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[3 * n + c] = (float)fi[c] + (float)fj[c];
      tau[3 * n + c] = (float)ti[c] + (float)tj[c];
    }
  }

#pragma unroll
  for (int c = 0; c < kSums; ++c)
    for (int off = 16; off > 0; off >>= 1) sums[c] += __shfl_down_sync(kFull, sums[c], off);
  for (int off = 16; off > 0; off >>= 1) masked += __shfl_down_sync(kFull, masked, off);
  if ((t & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) s_sums[warp][c] = sums[c];
    s_n[warp] = masked;
  }
  __syncthreads();
  if (t < kSums) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += s_sums[w][t];
    part[((size_t)list * gridDim.x + blockIdx.x) * kSums + t] = s;
  } else if (t == kSums) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_n[w];
    part_n[(size_t)list * gridDim.x + blockIdx.x] = s;
  }
}

// One block a list, one warp a total: warp c < kSums sums partial c over
// the list's blocks (lane-strided, then a shuffle tree), warp kSums the
// masked-row counts.
__global__ void __launch_bounds__(32 * (kSums + 1))
pair_reduce_totals(const double* __restrict__ part, const int* __restrict__ part_n,
                   int blocks, float* __restrict__ pe, float* __restrict__ virial,
                   int* __restrict__ stats) {
  const int list = blockIdx.x, c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (c < kSums) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s += part[((size_t)list * blocks + b) * kSums + c];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) {
      if (c == 0)
        pe[list] = (float)s;
      else
        virial[9 * list + c - 1] = (float)-s;
    }
  } else {
    int s = 0;
    for (int b = lane; b < blocks; b += 32) s += part_n[(size_t)list * blocks + b];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) stats[2 * list + 1] = s;
  }
}

}  // namespace

// lists pair lists of P slots each over N particles each: out [lists P,
// 24] the law's rows; pi, pj, perm (pair_jsort, per list) [lists P];
// both, valid [lists P] bool. Writes f, tau [lists N, 3], pe [lists],
// virial [lists, 3, 3], stats [lists, 2] (the live slots read, the rows
// with the mask set); part [lists, blocks, 10] and part_n [lists,
// blocks] are scratch, blocks = ceil(N / 256) (sh_pair_reduce_blocks).
extern "C" int sh_pair_reduce_blocks(int N) { return (N + kThreads - 1) / kThreads; }

extern "C" int sh_pair_reduce(const float* out, const long long* pi, const long long* pj,
                              const long long* perm, const unsigned char* both,
                              const unsigned char* valid, int N, int P, int lists, float* f,
                              float* tau, float* pe, float* virial, double* part, int* part_n,
                              int* stats, cudaStream_t stream) {
  if (N < 1 || P < 0 || lists < 1 || lists > 65535) return (int)cudaErrorInvalidValue;
  const int blocks = sh_pair_reduce_blocks(N);
  pair_reduce_kernel<<<dim3(blocks, lists), kThreads, 0, stream>>>(
      out, pi, pj, perm, both, valid, N, P, f, tau, part, part_n, stats);
  pair_reduce_totals<<<lists, 32 * (kSums + 1), 0, stream>>>(part, part_n, blocks, pe, virial,
                                                              stats);
  return (int)cudaGetLastError();
}
