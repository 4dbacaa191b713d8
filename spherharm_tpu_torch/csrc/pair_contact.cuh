// Shared by the stage-2 pair kernels of both laws (pair_contact.cu: the
// geometric law; pair_contact_cons.cu: the conservative law): the packed
// row layout, the gather of each pair's row by index (IndexedRows), the
// bf16 kernels' pre-scaled rows, the per-side sums, the pair-level
// epilogue (contact geometry from both sides, Hertz + damping + friction +
// rolling, the 24-float output row) and the launch. The node-blocked
// surface evaluation and the compiled degrees are sh_nodes.cuh's, shared
// with the wall kernel.
#pragma once

#include <cuda_pipeline.h>

#include "sh_nodes.cuh"

namespace shk {

constexpr int F = 64;      // packed row width
constexpr int NOUT = 24;   // output row width
constexpr int NPAR = 16;   // par row width (dt first), one row a replica
constexpr int WARPS = 4;   // pairs per block

// Packed-row slots (spherharm_tpu_torch/ops/contact_kernels.py SLOTS).
enum Slot {
  XI = 0, VI = 3, QI = 6, OMI = 10, MI = 13, RBI = 14, RMI = 15, RCI = 16,
  XJ = 17, VJ = 20, QJ = 23, OMJ = 27, MJ = 30, RBJ = 31, RMJ = 32, RCJ = 33,
  HIST = 34, MASK = 40, DV = 41, TAIL = 44, MAT = 45, TYP = 53, SCL = 55
};

// contact.particle_rows: x, v, q, omega, m, rmax s, rmin s, rchar s (a
// side's 17 slots, XI..RCI), then the scale s, active, one free column.
constexpr int ROW_W = 20;
constexpr int ROW_S = 17, ROW_ACT = 18;
constexpr int HW = 6;      // spring columns (HIST)

// Copy n floats to shared memory without waiting for them (cp.async); the
// caller commits the batch and waits for it before its barrier.
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
}

// The minimum image of d = x_j - x_i, step for step as
// contact.minimum_image forms it in f32 (images removed in the order c,
// b, a; rounding half to even; every product and difference rounded on
// its own, never fused). box: the list's edge lengths, then with tilted
// its tilt (xy, xz, yz).
__device__ __forceinline__ V3 minimum_image(V3 d, const float* box, bool tilted, int px,
                                            int py, int pz) {
  float dx = d.x, dy = d.y, dz = d.z;
  if (tilted) {
    if (pz) {
      const float n3 = rintf(__fdiv_rn(dz, box[2]));
      dx = __fsub_rn(dx, __fmul_rn(n3, box[4]));
      dy = __fsub_rn(dy, __fmul_rn(n3, box[5]));
      dz = __fsub_rn(dz, __fmul_rn(n3, box[2]));
    }
    if (py) {
      const float n2 = rintf(__fdiv_rn(dy, box[1]));
      dx = __fsub_rn(dx, __fmul_rn(n2, box[3]));
      dy = __fsub_rn(dy, __fmul_rn(n2, box[1]));
    }
    if (px) dx = __fsub_rn(dx, __fmul_rn(rintf(__fdiv_rn(dx, box[0])), box[0]));
    return v3(dx, dy, dz);
  }
  if (px) dx = __fsub_rn(dx, __fmul_rn(rintf(__fdiv_rn(dx, box[0])), box[0]));
  if (py) dy = __fsub_rn(dy, __fmul_rn(rintf(__fdiv_rn(dy, box[1])), box[1]));
  if (pz) dz = __fsub_rn(dz, __fmul_rn(rintf(__fdiv_rn(dz, box[2])), box[2]));
  return v3(dx, dy, dz);
}

// The rows of sh_pair_contact_indexed: each warp gathers its pair's
// packed row into shared memory from the pair list (pi, pj, valid, the
// springs), the particle rows, the shape types, the material table and
// the box. The lists of RL replicas or shards come list-major, ppl slots
// each, and slot p of list r reads particles r N + pi[p], r N + pj[p].
// slot(p) is read before the block's first barrier (whether the slot may
// be live); gather() then fills the row.
struct IndexedRows {
  const float* rows;           // [RL N, ROW_W] contact.particle_rows
  const long long* typ;        // [RL N] shape-type ids
  const long long* pi;         // [RL ppl]
  const long long* pj;         // [RL ppl]
  const unsigned char* valid;  // [RL ppl] pair_valid
  const float* hist;           // [RL ppl] rows of HW springs, hist_stride apart
  const float* tab;            // pair_tab [TR, tp, tp, 8], TR = RL (tab_rep) or 1
  const float* box;            // [RL, box_w]: lengths, then the tilt if box_w = 6
  int N, ppl, hist_stride, tp, tab_rep, box_w, px, py, pz;

  struct Slot {
    bool valid;
    size_t i, j;  // the two particles' rows
  };

  __device__ __forceinline__ Slot slot(int p) const {
    const size_t base = (size_t)(p / ppl) * N;
    return {valid[p] != 0, base + (size_t)pi[p], base + (size_t)pj[p]};
  }
  // Slot p's packed row (the layout of enum Slot) into s[0:F], for a valid
  // slot: the lanes load the two sides' slots, the springs, the material
  // row (clamped as state.pair_material clamps), the type ids and scales;
  // lane 0 then sets the mask and the minimum-image d. TAIL and the
  // columns past SCL stay zero (the law reads neither). Returns whether
  // the slot is live: both ends active, the mask contact_force_pairs
  // forms with valid.
  __device__ __forceinline__ bool gather(int p, const Slot& sl, float* s, int lane) const {
    const int r = p / ppl;
    const float* ri = rows + sl.i * ROW_W;
    const float* rj = rows + sl.j * ROW_W;
    const bool live = ri[ROW_ACT] > 0.5f && rj[ROW_ACT] > 0.5f;
    for (int c = lane; c < F; c += 32) {
      float v = 0.0f;
      if (c < XJ) {
        v = ri[c];
      } else if (c < HIST) {
        v = rj[c - XJ];
      } else if (c < MASK) {
        v = hist[(size_t)p * hist_stride + (c - HIST)];
      } else if (c >= MAT && c < TYP) {
        const long long ti = typ[sl.i] < tp - 1 ? typ[sl.i] : tp - 1;
        const long long tj = typ[sl.j] < tp - 1 ? typ[sl.j] : tp - 1;
        const size_t m = ((size_t)(tab_rep ? r : 0) * tp + ti) * tp + tj;
        v = tab[m * 8 + (c - MAT)];
      } else if (c == TYP || c == TYP + 1) {
        v = (float)typ[c == TYP ? sl.i : sl.j];
      } else if (c == SCL || c == SCL + 1) {
        v = (c == SCL ? ri : rj)[ROW_S];
      }
      s[c] = v;
    }
    __syncwarp();
    if (lane == 0) {
      const V3 dr = {__fsub_rn(s[XJ], s[XI]), __fsub_rn(s[XJ + 1], s[XI + 1]),
                     __fsub_rn(s[XJ + 2], s[XI + 2])};
      const V3 d = minimum_image(dr, box + (size_t)r * box_w, box_w == 6, px, py, pz);
      s[MASK] = 1.0f;
      s[DV] = d.x;
      s[DV + 1] = d.y;
      s[DV + 2] = d.z;
    }
    __syncwarp();
    return live;
  }
};

// A bf16 kernel's pre-scaled rows: this warp's two rows bf(t[k] s), each
// value in both halves of a pair (one row a side of the pair), written to
// dst[0:2W] by the warp's lanes.
__device__ __forceinline__ void bf16_rows(const float* ri, float si, const float* rj, float sj,
                                          int W, int lane, __nv_bfloat162* dst) {
  for (int i = lane; i < W; i += 32) {
    dst[i] = __bfloat162bfloat162(__float2bfloat16_rn(__fmul_rn(ri[i], si)));
    dst[W + i] = __bfloat162bfloat162(__float2bfloat16_rn(__fmul_rn(rj[i], sj)));
  }
  __syncwarp();
}

// One side's depth moments s1, s2 and its centroid and normal sums.
struct Moments {
  float s1, s2;
  V3 cen, nsum;
};

// With the conservative law, also g_* [m]: the gradients of s_{m+1}
// w.r.t. the separation d, the world rotation of the probing body a and
// of b.
struct Side : Moments {
  V3 g_d[2], g_ta[2], g_tb[2];
};

// The pair-level epilogue, run redundantly on every lane (all hold the
// side totals); lane 0 writes the 24-float row. ma/mb: the two sides'
// moments; with kCons, a/b carry their gradients (the exact-gradient
// elastic force), else the geometric law's force along the integral
// normal at the centroid. par: this pair's replica's row (replica_par).
// The row also carries d in columns 17-19 and the mask (1) in column 20,
// for the reduction after the law.
template <bool kCons>
__device__ __forceinline__ void pair_epilogue(const float* row, const Moments& ma,
                                              const Moments& mb, const Side& a, const Side& b,
                                              V3 d, float dist, float inv_dist, float rbi,
                                              float rbj, const float* par, int lane, float* o) {
  // Contact geometry from both sides.
  const float s1 = ma.s1 + mb.s1, s2 = ma.s2 + mb.s2;
  const float denom = fmaxf(s1, 1e-30f);
  const V3 cen = s1 > 0.0f ? (ma.cen + mb.cen + mb.s1 * d) / denom : 0.5f * d;
  const V3 nraw = ma.nsum - mb.nsum;
  const float nn = sqrtf(fmaxf(dot3(nraw, nraw), 1e-40f));
  const V3 n_hat = nn > 1e-20f ? nraw / nn : -(inv_dist * d);
  const bool cull = (dist < rbi + rbj) && (dist > 1e-12f);
  const bool in_contact = cull && (s1 > 0.0f);
  const float delta = in_contact ? 1.5f * s2 / denom : 0.0f;

  const float rci = row[RCI], rcj = row[RCJ];
  const float r_eff = rci * rcj / fmaxf(rci + rcj, 1e-12f);
  const float mi = row[MI], mj = row[MJ];
  const float m_eff = mi * mj / fmaxf(mi + mj, 1e-30f);
  const float poly = sqrtf(fmaxf(delta * r_eff, 0.0f));
  const float dt = par[0];
  const Material mt = {row[MAT],     row[MAT + 1], row[MAT + 2], row[MAT + 3],
                       row[MAT + 4], row[MAT + 5], row[MAT + 6], row[MAT + 7]};

  const V3 vi = load3(row + VI), vj = load3(row + VJ);
  const V3 omi = load3(row + OMI), omj = load3(row + OMJ);
  const V3 arm_i = cen, arm_j = cen - d;
  const V3 v_rel = vi + cross3(omi, arm_i) - vj - cross3(omj, arm_j);
  const float vn_mag = dot3(v_rel, n_hat);
  const V3 vt = v_rel - vn_mag * n_hat;
  const float fn_mag = fmaxf(poly * (mt.kn * delta - m_eff * mt.gn * vn_mag), 0.0f);

  V3 xi, f_t, xi_r, tau_roll;
  friction_rolling(load3(row + HIST), load3(row + HIST + 3), n_hat, vt, in_contact, poly,
                   fn_mag, m_eff, r_eff, omi - omj, dt, mt, xi, f_t, xi_r, tau_roll);

  const V3 z = v3(0.0f, 0.0f, 0.0f);
  V3 force, torque, torque_j;
  if constexpr (kCons) {
    // Exact-gradient elastic force/torques. U = 0.4 kn sqrt(R) delta^2.5,
    // delta = 1.5 s2/s1: dU/ds2 = kn sqrt(R) delta^1.5 * 1.5/s1,
    // dU/ds1 = -(2/3) delta dU/ds2.
    const float coef_g = mt.kn * sqrtf(r_eff) * delta * sqrtf(fmaxf(delta, 0.0f));
    const float w2 = in_contact ? coef_g * 1.5f / denom : 0.0f;
    const float w1 = -(2.0f / 3.0f) * delta * w2;
    // Side ij differentiates w.r.t. (d, th_i, th_j); side ji saw d' = -d
    // with the roles swapped.
    const V3 gU_d = (w1 * a.g_d[0] + w2 * a.g_d[1]) - (w1 * b.g_d[0] + w2 * b.g_d[1]);
    const V3 gU_thi = (w1 * a.g_ta[0] + w2 * a.g_ta[1]) + (w1 * b.g_tb[0] + w2 * b.g_tb[1]);
    const V3 gU_thj = (w1 * a.g_tb[0] + w2 * a.g_tb[1]) + (w1 * b.g_ta[0] + w2 * b.g_ta[1]);
    const bool okf = isfinite(gU_d.x) && isfinite(gU_d.y) && isfinite(gU_d.z) &&
                     isfinite(gU_thi.x) && isfinite(gU_thi.y) && isfinite(gU_thi.z) &&
                     isfinite(gU_thj.x) && isfinite(gU_thj.y) && isfinite(gU_thj.z);
    // U depends on x through d = x_j - x_i: force on i is +dU/dd;
    // torque = -dU/dtheta.
    const V3 f_el = okf ? gU_d : z;
    const V3 tau_ei = okf ? -gU_thi : z;
    const V3 tau_ej = okf ? -gU_thj : z;
    const float fn_damp = -(poly * m_eff * mt.gn * vn_mag);
    const V3 f_vis = in_contact ? fn_damp * n_hat + f_t : z;
    force = f_el + f_vis;
    torque = tau_ei + cross3(arm_i, f_vis) + tau_roll;
    torque_j = tau_ej + cross3(arm_j, -f_vis) - tau_roll;
  } else {
    // Geometric law: Hertz + damping along the integral normal, applied
    // at the overlap centroid.
    force = in_contact ? fn_mag * n_hat + f_t : z;
    torque = cross3(arm_i, force) + tau_roll;
    torque_j = cross3(arm_j, -force) - tau_roll;
  }
  const float pe =
      in_contact ? 0.4f * mt.kn * sqrtf(r_eff) * delta * delta * sqrtf(delta) : 0.0f;

  if (lane == 0) {
    const float res[17] = {force.x,    force.y,    force.z,    torque.x, torque.y, torque.z,
                           torque_j.x, torque_j.y, torque_j.z, xi.x,     xi.y,     xi.z,
                           xi_r.x,     xi_r.y,     xi_r.z,     pe,       in_contact ? 1.0f : 0.0f};
#pragma unroll
    for (int c = 0; c < 17; ++c) o[c] = res[c];
    o[17] = d.x;
    o[18] = d.y;
    o[19] = d.z;
    o[20] = 1.0f;
#pragma unroll
    for (int c = 21; c < NOUT; ++c) o[c] = 0.0f;
  }
}

// The par row of this warp's pair: the pairs of R replicas come
// replica-major, rpr rows a replica, one par row each. Read from the
// block and warp ids at the epilogue, so nothing of it is live in the
// node loop.
__device__ __forceinline__ const float* replica_par(const float* par, int rpr) {
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  return par + (size_t)(p / rpr) * NPAR;
}

using PairKernel = void (*)(IndexedRows, const float*, int, int, const float*, int,
                            const float*, int, int, int, float*);

// Launch a stage-2 kernel, a warp a pair and WARPS pairs a block, with
// smem bytes of dynamic shared memory; returns cudaGetLastError().
inline int launch_pairs(PairKernel kernel, size_t smem, const IndexedRows& in,
                        const float* tbl, int T, int W, const float* cap, int G,
                        const float* par, int lmax, int P, int rpr, float* out,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P + WARPS - 1) / WARPS;
  kernel<<<blocks, WARPS * 32, smem, stream>>>(in, tbl, T, W, cap, G, par, lmax, P, rpr, out);
  return (int)cudaGetLastError();
}

// The conservative law's launch (pair_contact_cons.cu), for the C entry
// in pair_contact.cu.
int launch_pair_conservative(const IndexedRows& in, const float* tbl, int T, int W,
                             const float* cap, int G, const float* par, int lmax, int P,
                             int rpr, bool bf16, float* out, cudaStream_t stream);

}  // namespace shk
