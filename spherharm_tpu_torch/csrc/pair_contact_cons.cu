// Stage-2 SH pair contact in the conservative law, hand-written for
// sm_90a: K1 (f32) and K3 conservative (bfloat16 Horner chains).
//
// Replaces: spherharm_tpu/ops/contact_pallas.py pair_contact_pallas ->
//   _make_kernel(lmax, conservative=True) with _probe_cons (both-sided
//   cap quadrature + hand-derived gradient of the depth moments), and
//   _make_kernel(lmax, conservative=True, bf16=True): the A/B/At/Bt
//   Horner chains of every surface evaluation in bfloat16 on the table
//   rows pre-scaled by the particle's scale and rounded to bf16, the rest
//   in f32. The reference switches bf16 on for every stage-2 call with
//   SPHERHARM_STAGE2_BF16=1.
//
// What bounds it on this card: arithmetic (chip_smoke.py's bound: 2 sides
// x G cap nodes x (468 FLOP of probe and gradient algebra + 2 surface
// evaluations of 441 FLOP at lmax 8) per pair, against 352 bytes of
// traffic). Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W, on 16,384 contact-rich pairs at lmax 8 and 128 nodes: K1
// 0.327 ms against its 0.083 ms bound (25 %), K3 0.357 ms against 0.065
// (18 %); the run-time-degree kernel this replaced took 1.06 and 1.67 ms.
// What holds it there, from the SASS of the lmax-8 f32 kernel
// (chip_smoke.py's "sass" line): the node loop issues 2,444
// instructions per 2 nodes and side, 1.81x the FMA-slots the bound
// counts, of which 1,714 are FP32 (FFMA 1,189, FMUL 430, FADD 95) and 362
// shared loads; at 223 registers an SM holds 2 blocks (2 warps a
// scheduler) and the kernel issues at about half of one instruction a
// scheduler and clock. The design:
//   * one warp per pair, lanes striding over the cap nodes (any G); the
//     per-type power table and the cap grid in shared memory;
//   * the degree is a template parameter L: every Horner run's offset
//     and length is a compile-time constant, the chains unroll fully and
//     the table loads issue ahead of the FMAs that use them. The degrees
//     the port's conservative callers use are compiled (with_degree: 0
//     the two-body collision, 2 and 4 the small drums and tests, 8 the
//     drum and the drift gas); any other degree takes L = -1, the same
//     template with the degree read at run time;
//   * a lane evaluates NB of its cap nodes together: each coefficient
//     load feeds NB independent FMAs, and the A, B, At and Bt chains of
//     one m run side by side (4 NB independent chains). Side b's
//     evaluation needs side a's radius at the same node, so the NB
//     a-evaluations run first, then the NB b-evaluations;
//   * K3 builds each side's pre-scaled bf16 row bf(t[k] s) once per warp
//     in shared memory, duplicated into both halves of a __nv_bfloat162,
//     and runs the chains of two nodes per instruction with __hmul2_rn /
//     __hadd2_rn (never fused): the bits of the twin's "f32 op, then round
//     to bf16" for bf16 operands (a product of two bf16 values is exact in
//     f32; for a sum, f32's 24 bits >= 2 x 8 + 2 make the double rounding
//     innocuous);
//   * the 46 per-side sums reduce with a reduce-scatter butterfly (48
//     shuffles where 46 xor-tree sums took 230), through 48 floats of
//     shared memory per side and warp; the pair-level epilogue
//     (pair_contact.cuh) runs redundantly on all lanes, lane 0 writes.
// Built without fast math: approximate division would loosen parity.

#include "pair_contact.cuh"

using namespace shk;

namespace {

constexpr int NB = 2;          // cap nodes a lane evaluates together
// Blocks an SM must hold: 2 lets ptxas use up to 255 registers, and every
// instantiation fits without a spill (197-255; 223 and 218 at lmax 8).
// 3 blocks (168 registers) spill 92-216 bytes, 4 (128) 328-656
// (throwaway builds, PERF.md section 6).
constexpr int MIN_BLOCKS = 2;
constexpr int NRED = 48;       // per-side sums, padded to 3 x 16

// Slots of the per-side sums: s1, s2, centroid, normal, then for each
// moment mo = 0, 1 (of s_{mo+1}) at MO + MO_W mo: the gradient w.r.t. d,
// the rotations of a and b, and the cotangents of e_b, t1, t2 and
// (1 - cos_gmax).
enum Sum { S1 = 0, S2 = 1, CEN = 2, NSUM = 5, MO = 8, MO_W = 19 };
enum SumMo { GD = 0, GTA = 3, GTB = 6, CEB = 9, CT1 = 12, CT2 = 15, CONEM = 18 };

__device__ __forceinline__ void add3(float (&acc)[NRED], int i, V3 v) {
  acc[i] += v.x;
  acc[i + 1] += v.y;
  acc[i + 2] += v.z;
}

// One level of the reduce-scatter butterfly over the first H2 sums: the
// lane keeps one half, hands the other to its partner lane ^ OFF and adds
// the partner's share of the half it keeps.
template <int H2, int OFF>
__device__ __forceinline__ void scatter_level(float (&v)[NRED], int lane, int& base) {
  constexpr int H = H2 / 2;
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if (upper) base += H;
}

// The warp's totals of the NRED sums into red[0:NRED]: four halving
// levels leave each lane the partial sums of 3 slots over its 16-lane
// half (lane bit 0 fixed), one xor-1 exchange completes them, the even
// lanes write. 48 shuffles, then every lane may read red.
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NRED], int lane, float* red) {
  static_assert(NRED == 48, "3 slots a lane after four levels");
  int base = 0;
  scatter_level<48, 16>(v, lane, base);
  scatter_level<24, 8>(v, lane, base);
  scatter_level<12, 4>(v, lane, base);
  scatter_level<6, 2>(v, lane, base);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
  if ((lane & 1) == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) red[base + i] = v[i];
  }
  __syncwarp();
}

// Probe a's cap nodes against b (twin of _probe_cons). d3 = x_b - x_a;
// red: this side's NRED floats of the warp's shared memory.
template <int L, bool kBf16>
__device__ __forceinline__ Side probe_side(const Coef<kBf16>* tbl_a, float s_a,
                                           const Coef<kBf16>* tbl_b, float s_b, Q4 q_a,
                                           Q4 q_b, V3 d3, float dist, float inv_dist,
                                           float rb_b, float rm_a, float rb_a,
                                           const float* cap, int G, int lmax, int lane,
                                           float* red) {
  const V3 e_w = inv_dist * d3;
  const V3 e_b = rot_inv(q_a, e_w);

  // cos_gmax(dist) and its derivative (clip subgradients as autodiff).
  const float rb2 = rb_b * rb_b;
  const float rho_star = sqrtf(fmaxf(dist * dist - rb2, 0.0f));
  const bool unclipped = (rho_star > rm_a) && (rho_star < rb_a);
  const float rho_c = clampf(rho_star, rm_a, rb_a);
  const float cg_raw = (rho_c * rho_c + dist * dist - rb2) / fmaxf(2.0f * rho_c * dist, 1e-12f);
  const float cos_gmax = clampf(cg_raw, -1.0f, 1.0f - 1e-6f);
  const bool cg_free = (cg_raw > -1.0f) && (cg_raw < 1.0f - 1e-6f);
  const float inv_rcd = 1.0f / fmaxf(rho_c * dist * dist, 1e-30f);
  float dcg_ddist =
      unclipped ? rb2 * inv_rcd : 0.5f * (dist * dist - rho_c * rho_c + rb2) * inv_rcd;
  if (!cg_free) dcg_ddist = 0.0f;
  const float one_m = 1.0f - cos_gmax;

  V3 h, t1, t2;
  float inv_t1;
  orthobasis(e_b, h, t1, t2, inv_t1);

  float acc[NRED];
#pragma unroll
  for (int i = 0; i < NRED; ++i) acc[i] = 0.0f;

  // Work of this loop, counted from its body (an FMA counts 2, any other
  // arithmetic op 1; chip_smoke.py's bound reads this line):
  // node-flops[pair_contact_conservative]: 468 + 2 x radius_grad_power per node and side, 2 sides
  // node-flops[pair_contact_conservative_bf16]: 468 + 2 x radius_grad_power_bf16 per node and side, 2 sides
  for (int k0 = lane; k0 < G; k0 += 32 * NB) {
    // The table rows do not change in this loop, and with the degree known
    // the compiler would hoist all 2 W of their loads out of it: they do
    // not fit in registers and spill to local memory. An offset it cannot
    // see through keeps the loads in the loop, in shared memory.
    int row0 = 0;
    asm volatile("" : "+r"(row0));
    const Coef<kBf16>* ta = tbl_a + row0;
    const Coef<kBf16>* tb = tbl_b + row0;
    // Node j of this block is k0 + 32 j; one past G repeats node k0 and
    // adds nothing.
    bool valid[NB];
    float cx[NB], glw[NB], cos_g[NB], sin_g[NB], sc[NB], ss[NB];
    V3 dir[NB];
    float ct[NB], st[NB], cp[NB], sp[NB], r_a[NB], drt_a[NB], drp_a[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int k = k0 + 32 * j;
      valid[j] = k < G;
      const int kc = valid[j] ? k : k0;
      cx[j] = cap[kc];
      glw[j] = cap[G + kc];
      const float cpsi = cap[2 * G + kc], spsi = cap[3 * G + kc];
      cos_g[j] = 1.0f - one_m * cx[j];
      sin_g[j] = sqrtf(fmaxf(1.0f - cos_g[j] * cos_g[j], 1e-12f));
      sc[j] = sin_g[j] * cpsi;
      ss[j] = sin_g[j] * spsi;
      dir[j] = cos_g[j] * e_b + sc[j] * t1 + ss[j] * t2;
      unit_trig(dir[j], ct[j], st[j], cp[j], sp[j]);
    }
    radius_grad_nodes<L, kBf16, NB>(ta, s_a, lmax, ct, st, cp, sp, r_a, drt_a, drp_a);

    V3 ga[NB], rel[NB], w3[NB], uh[NB];
    float rho[NB], inv_rho[NB];
    float ct_b[NB], st_b[NB], cp_b[NB], sp_b[NB], r_b[NB], drt_b[NB], drp_b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      // Tangent surface gradient of r_a (a's body frame).
      const float gpa = drp_a[j] * (1.0f / fmaxf(st[j], 1e-6f));
      ga[j] = {drt_a[j] * ct[j] * cp[j] - gpa * sp[j], drt_a[j] * ct[j] * sp[j] + gpa * cp[j],
               -drt_a[j] * st[j]};
      rel[j] = rot(q_a, r_a[j] * dir[j]);
      w3[j] = rel[j] - d3;
      const V3 u3 = rot_inv(q_b, w3[j]);
      rho[j] = sqrtf(fmaxf(dot3(u3, u3), 1e-24f));
      inv_rho[j] = 1.0f / rho[j];
      uh[j] = inv_rho[j] * u3;
      unit_trig(uh[j], ct_b[j], st_b[j], cp_b[j], sp_b[j]);
    }
    radius_grad_nodes<L, kBf16, NB>(tb, s_b, lmax, ct_b, st_b, cp_b, sp_b, r_b, drt_b,
                                    drp_b);

#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!valid[j]) continue;
      const float gpb = drp_b[j] * (1.0f / fmaxf(st_b[j], 1e-6f));
      const V3 gb = {drt_b[j] * ct_b[j] * cp_b[j] - gpb * sp_b[j],
                     drt_b[j] * ct_b[j] * sp_b[j] + gpb * cp_b[j], -drt_b[j] * st_b[j]};
      const float glr2 = glw[j] * r_a[j] * r_a[j];
      const float A = one_m * glr2;  // inclination-free measure

      // Depth moments (no containment indicator).
      const float depth_raw = r_b[j] - rho[j];
      const bool inside = depth_raw > 0.0f;
      const float D = fmaxf(depth_raw, 0.0f);
      const float wd = A * D;
      acc[S1] += wd;
      acc[S2] += wd * D;
      add3(acc, CEN, wd * rel[j]);
      const V3 nb = surface_normal(r_b[j], drt_b[j], drp_b[j], ct_b[j], st_b[j], cp_b[j],
                                   sp_b[j]);
      add3(acc, NSUM, wd * rot(q_b, nb));

      // Gradient integrals: dD propagates through u as
      // cw . (d rel - dd + dtheta_b x w).
      const V3 cw = rot(q_b, inv_rho[j] * gb - uh[j]);
      const V3 crb = rot_inv(q_a, cw);
      const float crb_dot_dir = dot3(crb, dir[j]);
      const V3 rel_x_cw = cross3(rel[j], cw);
      const V3 cw_x_w = cross3(cw, w3[j]);
      const float two_gl_r = 2.0f * one_m * glw[j] * r_a[j];
      const float cgs = cos_g[j] / sin_g[j];
#pragma unroll
      for (int mo = 0; mo < 2; ++mo) {
        const int o = MO + MO_W * mo;
        const float al = mo == 0 ? D : D * D;
        const float be = mo == 0 ? (inside ? A : 0.0f) : 2.0f * wd;
        add3(acc, o + GD, be * cw);
        add3(acc, o + GTA, be * rel_x_cw);
        add3(acc, o + GTB, be * cw_x_w);
        const float c_ra = al * two_gl_r + be * crb_dot_dir;
        const V3 cdir = (be * r_a[j]) * crb + c_ra * ga[j];
        const float cdir_dot_eb = dot3(cdir, e_b);
        const float cdir_dot_dir = dot3(cdir, dir[j]);
        const float cdir_dot_p = (cdir_dot_dir - cos_g[j] * cdir_dot_eb) / sin_g[j];
        add3(acc, o + CEB, cos_g[j] * cdir);
        add3(acc, o + CT1, sc[j] * cdir);
        add3(acc, o + CT2, ss[j] * cdir);
        acc[o + CONEM] += al * glr2 - cx[j] * (cdir_dot_eb - cgs * cdir_dot_p);
      }
    }
  }

  warp_reduce_scatter(acc, lane, red);
  Side out;
  out.s1 = red[S1];
  out.s2 = red[S2];
  out.cen = load3(red + CEN);
  out.nsum = load3(red + NSUM);
#pragma unroll
  for (int mo = 0; mo < 2; ++mo) {
    const float* g = red + MO + MO_W * mo;
    const V3 gd = -load3(g + GD);
    V3 gta = load3(g + GTA);
    const V3 gtb = load3(g + GTB);
    const V3 ceb = load3(g + CEB);
    const V3 ct1 = load3(g + CT1);
    const V3 ct2 = load3(g + CT2);
    const float conem = g[CONEM];
    // Orthobasis backward: t2 = e x t1, t1 = normalize(e x h).
    const V3 ct1p = ct1 + cross3(ct2, e_b);
    const float t1_dot = dot3(t1, ct1p);
    const V3 c_tau = inv_t1 * (ct1p - t1_dot * t1);
    const V3 c_e = ceb + cross3(t1, ct2) + cross3(h, c_tau);
    // e_b = R_a^T e_w: rotation of a picks up (R_a c_eb) x e_w; e_w
    // flows to d through the normalised direction.
    const V3 Rc = rot(q_a, c_e);
    gta = gta + cross3(Rc, e_w);
    const float ew_dot_Rc = dot3(e_w, Rc);
    out.g_d[mo] = gd + inv_dist * (Rc - ew_dot_Rc * e_w) - (conem * dcg_ddist) * e_w;
    out.g_ta[mo] = gta;
    out.g_tb[mo] = gtb;
  }
  return out;
}

template <int L, bool kBf16>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    pair_conservative_kernel(const float* __restrict__ packed, const float* __restrict__ tbl,
                             int T, int W, const float* __restrict__ cap, int G,
                             const float* __restrict__ par, int lmax, int P, int rpr,
                             float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_tbl = smem;               // [T, W] power table
  float* s_cap = s_tbl + T * W;      // [4, G] cap grid
  float* s_red = s_cap + 4 * G;      // [WARPS, 2, NRED] side totals
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) s_tbl[i] = tbl[i];
  for (int i = threadIdx.x; i < 4 * G; i += blockDim.x) s_cap[i] = cap[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= P) return;
  const float* row = packed + (size_t)p * F;
  float* o = out + (size_t)p * NOUT;
  if (!(row[MASK] > 0.5f)) {
    if (lane < NOUT) o[lane] = 0.0f;
    return;
  }

  const V3 d = load3(row + DV);
  const float dist = sqrtf(fmaxf(dot3(d, d), 1e-24f));
  const float inv_dist = 1.0f / dist;
  const Q4 qi = load4(row + QI), qj = load4(row + QJ);
  const int ti = min(max((int)row[TYP], 0), T - 1);
  const int tj = min(max((int)row[TYP + 1], 0), T - 1);
  const float si = row[SCL], sj = row[SCL + 1];
  const float rbi = row[RBI], rbj = row[RBJ];
  float* red = s_red + warp * 2 * NRED;

  Side a, b;
  if constexpr (kBf16) {
    // This warp's two rows bf(t[k] s), each in both halves of a pair
    // ([WARPS, 2, W] after the side totals).
    __nv_bfloat162* tb =
        reinterpret_cast<__nv_bfloat162*>(s_red + WARPS * 2 * NRED) + warp * 2 * W;
    bf16_rows(s_tbl + ti * W, si, s_tbl + tj * W, sj, W, lane, tb);
    a = probe_side<L, true>(tb, si, tb + W, sj, qi, qj, d, dist, inv_dist, rbj, row[RMI], rbi,
                            s_cap, G, lmax, lane, red);
    b = probe_side<L, true>(tb + W, sj, tb, si, qj, qi, -d, dist, inv_dist, rbi, row[RMJ], rbj,
                            s_cap, G, lmax, lane, red + NRED);
  } else {
    a = probe_side<L, false>(s_tbl + ti * W, si, s_tbl + tj * W, sj, qi, qj, d, dist, inv_dist,
                             rbj, row[RMI], rbi, s_cap, G, lmax, lane, red);
    b = probe_side<L, false>(s_tbl + tj * W, sj, s_tbl + ti * W, si, qj, qi, -d, dist,
                             inv_dist, rbi, row[RMJ], rbj, s_cap, G, lmax, lane, red + NRED);
  }
  pair_epilogue<true>(row, a, b, a, b, d, dist, inv_dist, rbi, rbj, replica_par(par, rpr), lane,
                      o);
}

}  // namespace

int shk::launch_pair_conservative(const float* packed, const float* tbl, int T, int W,
                                  const float* cap, int G, const float* par, int lmax, int P,
                                  int rpr, bool bf16, float* out, cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)(T * W + 4 * G + WARPS * 2 * NRED);
  if (bf16) smem += sizeof(__nv_bfloat162) * (size_t)(WARPS * 2 * W);
  return with_degree(lmax, [&](auto degree) {
    constexpr int L = decltype(degree)::value;
    const PairKernel kernel =
        bf16 ? pair_conservative_kernel<L, true> : pair_conservative_kernel<L, false>;
    return launch_pairs(kernel, smem, packed, tbl, T, W, cap, G, par, lmax, P, rpr, out,
                        stream);
  });
}
