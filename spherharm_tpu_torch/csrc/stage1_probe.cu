// Stage-1 r-only containment probe, hand-written for sm_90a.
//
// Replaces: spherharm_tpu/ops/contact_pallas.py
//   stage1_depth_pallas -> _make_stage1_kernel(lmax, l1, bf16), every
//   variant: K4 (l1 = lmax, bf16 = False, the full-basis f32 probe the
//   rebuild-time prefilter runs) and K5 (l1 < lmax and/or bf16 = True,
//   the function's own defaults l1 = 4, bf16 = True). The surface is
//   evaluated at degree l1 from a degree-l1 table; bf16 is the template
//   parameter kBf16 (the whole radius evaluation in bfloat16,
//   sh_device.cuh radius_power_ab<true>).
//
// Per candidate pair it writes an upper bound on the max signed node depth
// (r_target - rho) over both probe directions on the coarse cap1 grid,
// plus the packed tail column (the truncation bound beyond degree l1),
// plus 0.02 (rb_i + rb_j) with bf16 (the reference's rounding margin);
// pairs apart by their bounding spheres give rsum - dist, dead rows -1e9.
//
// What bounds it on this card: arithmetic again, though 8x lighter than
// the stage-2 kernel (r only, from the 81-float A/B prefix at lmax 8, on
// 32 nodes, no gradients): ~2 x 32 x 2 x 0.5 kFLOP per 256-byte row. It
// runs once per rebuild over the whole candidate list (5n rows). At
// l1 = 4 (25 floats, ~4x fewer FLOPs) on a list whose rows are mostly
// masked or sphere-separated, the 256-byte row read bounds it instead.
// Design: one warp per pair, one lane per cap1 node (stride loop for
// G1 > 32), the table and the grid in shared memory, a warp max
// reduce; masked and sphere-separated rows skip the probe entirely. The
// bf16 instance rounds each pre-scaled coefficient in registers as the
// chain reads it, like pair_contact.cu's K3.

#include <math.h>

#include "sh_device.cuh"

using namespace shk;

namespace {

constexpr int F = 64;
constexpr int WARPS = 8;
enum Slot { QI = 6, RBI = 14, RMI = 15, QJ = 23, RBJ = 31, RMJ = 32, MASK = 40, DV = 41,
            TAIL = 44, TYP = 53, SCL = 55 };

// Max over a's cap1 nodes of (r_b(u) - rho); d3 = x_b - x_a.
template <bool kBf16>
__device__ float probe_side(const float* tbl_a, float s_a, const float* tbl_b, float s_b,
                            Q4 q_a, Q4 q_b, V3 d3, float dist, float inv_dist, float rb_b,
                            float rm_a, float rb_a, const float* cap, int G, int l1,
                            int lane) {
  const V3 e_b = rot_inv(q_a, inv_dist * d3);
  const float rho_star = sqrtf(fmaxf(dist * dist - rb_b * rb_b, 0.0f));
  const float rho_c = clampf(rho_star, rm_a, rb_a);
  float cos_gmax =
      (rho_c * rho_c + dist * dist - rb_b * rb_b) / fmaxf(2.0f * rho_c * dist, 1e-12f);
  cos_gmax = clampf(cos_gmax, -1.0f, 1.0f - 1e-6f);
  const float one_m = 1.0f - cos_gmax;
  V3 h, t1, t2;
  float inv_t1;
  orthobasis(e_b, h, t1, t2, inv_t1);

  float best = -INFINITY;
  // Work of this loop, counted from its body (an FMA counts 2, any other
  // arithmetic op 1; chip_smoke.py's bound reads this line):
  // node-flops[stage1_depth]: 120 + 2 x radius_power_ab per node and side, 2 sides
  // node-flops[stage1_depth_l1]: 120 + 2 x radius_power_ab per node and side, 2 sides
  // node-flops[stage1_depth_l1_bf16]: 120 + 2 x radius_power_ab_bf16 per node and side, 2 sides
  for (int k = lane; k < G; k += 32) {
    const float cos_g = 1.0f - one_m * cap[k];
    const float sin_g = sqrtf(fmaxf(1.0f - cos_g * cos_g, 0.0f));
    const V3 dir = cos_g * e_b + (sin_g * cap[2 * G + k]) * t1 + (sin_g * cap[3 * G + k]) * t2;
    float ct, st, cp, sp;
    unit_trig(dir, ct, st, cp, sp);
    const float r_a = radius_power_ab<kBf16>(tbl_a, s_a, l1, ct, st, cp, sp);
    const V3 u = rot_inv(q_b, rot(q_a, r_a * dir) - d3);
    const float rho = sqrtf(fmaxf(dot3(u, u), 1e-24f));
    unit_trig((1.0f / rho) * u, ct, st, cp, sp);
    const float r_b = radius_power_ab<kBf16>(tbl_b, s_b, l1, ct, st, cp, sp);
    best = fmaxf(best, r_b - rho);
  }
  return warp_max(best);
}

template <bool kBf16>
__global__ void __launch_bounds__(WARPS * 32)
    stage1_kernel(const float* __restrict__ packed, const float* __restrict__ tbl, int T,
                  int W, const float* __restrict__ cap, int G, int l1, int P,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_tbl = smem;
  float* s_cap = smem + T * W;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) s_tbl[i] = tbl[i];
  for (int i = threadIdx.x; i < 4 * G; i += blockDim.x) s_cap[i] = cap[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;
  const float* row = packed + (size_t)p * F;
  const V3 d = load3(row + DV);
  const float dist = sqrtf(fmaxf(dot3(d, d), 1e-24f));
  const float rbi = row[RBI], rbj = row[RBJ];
  const float rsum = rbi + rbj;
  float depth;
  if (!(row[MASK] > 0.5f && dist > 1e-12f)) {
    depth = -1e9f;
  } else if (!(dist < rsum)) {
    // Not probed (the cap geometry assumes dist < rsum), but surfaces lie
    // inside the bounding spheres, so rsum - dist bounds the depth.
    depth = rsum - dist;
  } else {
    const float inv_dist = 1.0f / dist;
    const Q4 qi = load4(row + QI), qj = load4(row + QJ);
    const int ti = min(max((int)row[TYP], 0), T - 1);
    const int tj = min(max((int)row[TYP + 1], 0), T - 1);
    const float si = row[SCL], sj = row[SCL + 1];
    const float m_ij = probe_side<kBf16>(s_tbl + ti * W, si, s_tbl + tj * W, sj, qi, qj, d,
                                         dist, inv_dist, rbj, row[RMI], rbi, s_cap, G, l1,
                                         lane);
    const float m_ji = probe_side<kBf16>(s_tbl + tj * W, sj, s_tbl + ti * W, si, qj, qi, -d,
                                         dist, inv_dist, rbi, row[RMJ], rbj, s_cap, G, l1,
                                         lane);
    depth = fmaxf(m_ij, m_ji) + row[TAIL];
    if (kBf16) depth += 0.02f * rsum;
  }
  if (lane == 0) out[p] = depth;
}

template <bool kBf16>
int launch(const float* packed, const float* tbl1, int T, int W, const float* cap1, int G,
           int l1, int P, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(T * W + 4 * G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stage1_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P + WARPS - 1) / WARPS;
  stage1_kernel<kBf16><<<blocks, WARPS * 32, smem, stream>>>(packed, tbl1, T, W, cap1, G, l1,
                                                             P, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tbl1: [T, (l1+1)^2] degree-l1 A/B table rows (W = (l1+1)^2).
extern "C" int sh_stage1_depth(const float* packed, const float* tbl1, int T, int W,
                               const float* cap1, int G, int l1, int bf16, int P, float* out,
                               cudaStream_t stream) {
  return bf16 ? launch<true>(packed, tbl1, T, W, cap1, G, l1, P, out, stream)
              : launch<false>(packed, tbl1, T, W, cap1, G, l1, P, out, stream);
}
