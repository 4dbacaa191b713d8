// Wall contact (plane / inside of a cylinder), hand-written for sm_90a.
//
// Replaces: spherharm_tpu/ops/walls_pallas.py
//   wall_contact_pallas -> _make_wall_kernel(lmax, "plane" | "cylinder")
//   (K7: the plane; K6: the cylinder).
//
// Per near-wall particle: a cap toward the wall (cos gamma_max =
// dist_w / rmax), power-basis r, gradient and surface normal at each cap
// node, inclination-weighted area, depth against the analytic wall
// (plane: -(p - p0) . u0; cylinder: |p_perp| - R), depth moments, then
// Hertz + damping + Coulomb friction + rolling against the wall surface
// velocity v0 + W x c.
//
// What bounds it on this card: arithmetic (one surface evaluation per
// node, 441 FLOP at lmax 8 (chip_smoke.horner_flops), plus 139-155 FLOP
// of cap, normal and depth algebra, against 32 + 16 floats of traffic per
// particle). The design is the stage-2 pair kernels' (pair_contact.cu)
// with one side, on the helpers of sh_nodes.cuh:
//   * one warp per particle, lanes striding over the cap nodes (any G: 128
//     at 8x16, 288 at the deposition's 12x24); the unit-scale per-type
//     power table [T, W] and the cap grid [4, G] in shared memory, staged
//     once per block; a particle's row is picked by the type id in its
//     packed row and its surface scaled by its scale at the end, so no
//     per-particle table row is gathered in device memory;
//   * the degree is a template parameter L (with_degree: 0, 2, 4, 8
//     compiled, any other lmax L = -1, read at run time): every Horner
//     run's offset and length is a compile-time constant and the chains
//     unroll fully;
//   * a lane evaluates NB of its cap nodes together (radius_grad_nodes):
//     each shared-memory coefficient load feeds NB FMAs. NB is 3 where
//     3-node blocks span fewer node slots than 2-node ones (node_slots:
//     the deposition's 288 nodes), else 2; a node past G repeats a valid
//     node behind a flag and adds nothing;
//   * the table loads stay in the node loop, behind an offset the compiler
//     cannot see through (at a fixed degree it would hoist them all and
//     spill them to local memory);
//   * the 8 node sums (s1, s2, centroid, normal) reduce with xor shuffles,
//     the force law runs on every lane and lane 0 writes the 16-float row.
// The wall kind is a template parameter. Particles whose bounding sphere
// misses the wall skip the node loop (their sums are zero) but still run
// the spring update, as the reference does.
// Measured by device time over 20 launches (the variant timing in
// PERF.md section 6) on an NVIDIA H100 80GB HBM3 at 700.00 W: on the
// drum's 9,072-row batch (128 nodes, Lmax 8) K6 0.0431 ms and K7
// 0.0410 ms against 0.0099 /
// 0.0097 ms bounds (23 %), 2.9x faster than the per-particle-row kernel
// this replaces; on the deposition's 1,954 rows (288 nodes) 0.0207 /
// 0.0194 ms (23-24 %), 2.9-3.0x. The Lmax-8 cylinder node loop issues
// 597 instructions a node (2-node blocks), 2.0x the FMA slots the bound
// counts.
// Built without fast math: approximate division would loosen parity.

#include "sh_nodes.cuh"

using namespace shk;

namespace {

constexpr int FW = 32;     // packed row width
constexpr int NOUTW = 16;  // output row width
constexpr int NPARW = 24;  // par row width, one row a replica
constexpr int WARPS = 4;   // particles per block
// Blocks an SM must hold (__launch_bounds__): at most 65536 / (128 x 4)
// = 128 registers a thread, the most blocks at which no instantiation
// spills (93-128 registers; at 3 blocks the Lmax-8 kernels take 128-143).
constexpr int MIN_BLOCKS = 4;
enum Slot { X = 0, V = 3, Q = 6, OM = 10, M = 13, RMAX = 14, RCHAR = 15, NEAR = 16,
            DC = 17, NC = 18, HIST = 21, TYP = 27, SCL = 28 };

template <int KIND, int L, int NB>  // KIND 0: plane, 1: cylinder
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    wall_kernel(const float* __restrict__ packed, const float* __restrict__ tbl, int T, int W,
                const float* __restrict__ cap, int G, const float* __restrict__ par, int lmax,
                int B, int rpr, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_tbl = smem;           // [T, W] unit-scale power table
  float* s_cap = s_tbl + T * W;  // [4, G] cap grid
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) s_tbl[i] = tbl[i];
  for (int i = threadIdx.x; i < 4 * G; i += blockDim.x) s_cap[i] = cap[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= B) return;
  const float* row = packed + (size_t)p * FW;

  // dt and the materials from this particle's replica's row (R replicas'
  // rows come replica-major, rpr rows each); the wall's geometry is the
  // same in every row. At a compiled degree all of it is read here, the
  // geometry from row 0, as a single batch read it (the registers stay as
  // they were); at the run-time degree the geometry is read here from the
  // replica's row and the rest after the node loop (read here, the
  // 3-node variants spill).
  const float* pr = par + (size_t)(p / rpr) * NPARW;
  float dt, R;
  Material mt;
  V3 v0, Wv, p0, u0;
  if constexpr (L >= 0) {
    dt = pr[0];
    mt = {pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8]};
    v0 = load3(par + 9), Wv = load3(par + 12), p0 = load3(par + 15), u0 = load3(par + 18);
    R = par[21];
  } else {
    p0 = load3(pr + 15), u0 = load3(pr + 18);
    R = pr[21];
  }

  const V3 x = load3(row + X), v = load3(row + V), om = load3(row + OM);
  const Q4 q = load4(row + Q);
  const float m_eff = row[M], rmax = row[RMAX], r_eff = row[RCHAR];
  const bool near = row[NEAR] > 0.5f;
  const V3 nc = load3(row + NC);

  const V3 z = v3(0.0f, 0.0f, 0.0f);
  float s1 = 0.0f, s2 = 0.0f;
  V3 cen_num = z, nh = z;
  if (near) {
    const float* t_row = s_tbl + min(max((int)row[TYP], 0), T - 1) * W;
    const float scl = row[SCL];
    const V3 e_b = rot_inv(q, -nc);
    const float cos_gmax = clampf(-row[DC] / fmaxf(rmax, 1e-12f), -1.0f, 1.0f - 1e-6f);
    const float one_m = 1.0f - cos_gmax;
    V3 h, t1, t2;
    float inv_t1;
    orthobasis(e_b, h, t1, t2, inv_t1);
    // Work of this loop, counted from its body (an FMA counts 2, any other
    // arithmetic op 1; chip_smoke.py's bound reads these lines):
    // node-flops[wall_plane]: 139 + 1 x radius_grad_power per node and side, 1 side
    // node-flops[wall_cylinder]: 155 + 1 x radius_grad_power per node and side, 1 side
    for (int k0 = lane; k0 < G; k0 += 32 * NB) {
      // The table row does not change in this loop, and with the degree
      // known the compiler would hoist all W of its loads out of it: they
      // do not fit in registers and spill to local memory. An offset it
      // cannot see through keeps the loads in the loop, in shared memory.
      int row0 = 0;
      asm volatile("" : "+r"(row0));
      const float* t = t_row + row0;
      // Node j of this block is k0 + 32 j; one past G repeats node k0 and
      // adds nothing.
      bool valid[NB];
      float glw[NB];
      V3 dir[NB];
      float ct[NB], st[NB], cp[NB], sp[NB], r[NB], drt[NB], drp[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int k = k0 + 32 * j;
        valid[j] = k < G;
        const int kc = valid[j] ? k : k0;
        const float cos_g = 1.0f - one_m * s_cap[kc];
        const float sin_g = sqrtf(fmaxf(1.0f - cos_g * cos_g, 0.0f));
        dir[j] = cos_g * e_b + (sin_g * s_cap[2 * G + kc]) * t1 +
                 (sin_g * s_cap[3 * G + kc]) * t2;
        glw[j] = s_cap[G + kc];
        unit_trig(dir[j], ct[j], st[j], cp[j], sp[j]);
      }
      radius_grad_nodes<L, false, NB>(t, scl, lmax, ct, st, cp, sp, r, drt, drp);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (!valid[j]) continue;
        const V3 nb = surface_normal(r[j], drt[j], drp[j], ct[j], st[j], cp[j], sp[j]);
        const float cos_incl = clampf(dot3(nb, dir[j]), 0.05f, 1.0f);
        const float dA = (one_m * glw[j]) * r[j] * r[j] / cos_incl;
        const V3 rel = rot(q, r[j] * dir[j]);
        const V3 pw = x + rel;
        float depth;
        V3 n_at;
        if constexpr (KIND == 0) {
          depth = -dot3(pw - p0, u0);
          n_at = u0;
        } else {
          const V3 r2 = pw - p0;
          const V3 rv = r2 - dot3(r2, u0) * u0;
          const float rad = sqrtf(fmaxf(dot3(rv, rv), 1e-24f));
          depth = rad - R;
          n_at = (-1.0f / rad) * rv;
        }
        depth = fmaxf(depth, 0.0f);
        const float wd = dA * depth;
        s1 += wd;
        s2 += wd * depth;
        cen_num = cen_num + wd * rel;
        nh = nh + wd * n_at;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    cen_num = warp_sum3(cen_num);
    nh = warp_sum3(nh);
  }

  const bool in_contact = near && s1 > 0.0f;
  if constexpr (L < 0) {
    const float* pr2 = par + (size_t)(p / rpr) * NPARW;
    dt = pr2[0];
    mt = {pr2[1], pr2[2], pr2[3], pr2[4], pr2[5], pr2[6], pr2[7], pr2[8]};
    v0 = load3(pr2 + 9), Wv = load3(pr2 + 12);
  }
  const float denom = fmaxf(s1, 1e-30f);
  const float delta = in_contact ? 1.5f * s2 / denom : 0.0f;
  const V3 cen = in_contact ? cen_num / denom : z;
  const float nn = sqrtf(fmaxf(dot3(nh, nh), 1e-40f));
  const V3 n_hat = nn > 1e-10f ? nh / fmaxf(nn, 1e-12f) : nc;

  // Wall surface velocity at the contact point: v0 + W x c.
  const V3 v_rel = v + cross3(om, cen) - (v0 + cross3(Wv, x + cen));
  const float vn_mag = dot3(v_rel, n_hat);
  const V3 vt = v_rel - vn_mag * n_hat;
  const float poly = sqrtf(fmaxf(delta * r_eff, 0.0f));
  const float fn_mag = fmaxf(poly * (mt.kn * delta - m_eff * mt.gn * vn_mag), 0.0f);

  V3 xi, f_t, xi_r, tau_roll;
  friction_rolling(load3(row + HIST), load3(row + HIST + 3), n_hat, vt, in_contact, poly,
                   fn_mag, m_eff, r_eff, om - Wv, dt, mt, xi, f_t, xi_r, tau_roll);
  const V3 force = in_contact ? fn_mag * n_hat + f_t : z;
  const V3 torque = cross3(cen, force) + tau_roll;
  const float pe =
      in_contact ? 0.4f * mt.kn * sqrtf(r_eff) * delta * delta * sqrtf(delta) : 0.0f;

  if (lane == 0) {
    float* o = out + (size_t)p * NOUTW;
    const float res[14] = {force.x, force.y, force.z, torque.x, torque.y, torque.z, xi.x,
                           xi.y,    xi.z,    xi_r.x,  xi_r.y,   xi_r.z,   pe,
                           in_contact ? 1.0f : 0.0f};
#pragma unroll
    for (int c = 0; c < 14; ++c) o[c] = res[c];
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
}

using WallKernel = void (*)(const float*, const float*, int, int, const float*, int,
                            const float*, int, int, int, float*);

// A warp a particle and WARPS particles a block, the table and the cap
// grid in dynamic shared memory; returns cudaGetLastError().
template <int KIND>
int launch(const float* packed, const float* tbl, int T, int W, const float* cap, int G,
           const float* par, int lmax, int B, int rpr, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(T * W + 4 * G);
  const bool nb3 = node_slots(G, 3) < node_slots(G, 2);
  return with_degree(lmax, [&](auto degree) {
    constexpr int L = decltype(degree)::value;
    const WallKernel kernel = nb3 ? wall_kernel<KIND, L, 3> : wall_kernel<KIND, L, 2>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (B + WARPS - 1) / WARPS;
    kernel<<<blocks, WARPS * 32, smem, stream>>>(packed, tbl, T, W, cap, G, par, lmax, B, rpr,
                                                  out);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// par [B / rpr, 24]: the rows of B / rpr replicas, rpr rows each,
// replica-major (rpr = B: one batch); the geometry slots (9-23) equal in
// every row (pack_wall writes the wall's own in each).
extern "C" int sh_wall_contact(const float* packed, const float* tbl, int T, int W,
                               const float* cap, int G, const float* par, int lmax, int B,
                               int rpr, int kind, float* out, cudaStream_t stream) {
  if (rpr < 1) return (int)cudaErrorInvalidValue;
  if (kind == 0) return launch<0>(packed, tbl, T, W, cap, G, par, lmax, B, rpr, out, stream);
  if (kind == 1) return launch<1>(packed, tbl, T, W, cap, G, par, lmax, B, rpr, out, stream);
  return (int)cudaErrorInvalidValue;
}
