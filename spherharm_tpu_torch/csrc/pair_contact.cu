// Stage-2 SH pair contact, hand-written for sm_90a, in both elastic laws.
//
// Replaces: spherharm_tpu/ops/contact_pallas.py pair_contact_pallas ->
//   _make_kernel(lmax, conservative=True) with _probe_cons (K1: both-sided
//   cap quadrature + hand-derived gradient of the depth moments), and
//   _make_kernel(lmax, conservative=False) with _probe (K2: the geometric
//   law, inclination-weighted measure, force along the integral normal at
//   the centroid). The law is the template parameter kCons.
//   kBf16 = true is K3, _make_kernel(lmax, conservative, bf16=True): both
//   laws with the Horner chains of every surface evaluation in bfloat16
//   on the pre-scaled table rows, the assembly in f32
//   (sh_device.cuh radius_grad_power<true>). The reference switches it on
//   for every stage-2 call with SPHERHARM_STAGE2_BF16=1.
//
// What bounds it on this card: arithmetic. Per pair it evaluates 2 sides
// x G cap nodes x 2 power-basis surface evaluations (Horner runs over a
// 177-float table at lmax 8, ~0.9k FLOP each) plus vector algebra (~300
// FLOP a node for K1's gradient integrals, ~150 for K2's normals),
// against 64 + 24 floats of traffic per pair: some 10^5-10^6 FLOP per
// 352 bytes, far above the ridge point. The design keeps everything on
// chip and makes the FLOPs cheap to schedule:
//   * one warp per pair, lanes striding over the cap nodes (any G: 128 at
//     8x16, 288 at the deposition's 12x24);
//   * the per-type power table (T x W floats, ~5.7 KB at T = 8, lmax 8)
//     and the cap grid (4 G floats) live in shared memory, indexed by the
//     type id carried in the packed row (the TPU's one-hot matmul gather
//     has no reason to exist here);
//   * the per-side node sums (K1: s1, s2, centroid, normal and the 38
//     gradient integrals; K2: s1, s2, centroid, normal only) are reduced
//     with xor shuffles, so every lane ends with the totals and no
//     shared-memory reduction or block barrier is needed; the pair-level
//     chains and the force law then run redundantly on all lanes and lane
//     0 writes the 24-float row;
//   * a masked row (mask <= 0.5) writes zeros and skips the body;
//   * K3 keeps the f32 table in shared memory and rounds each pre-scaled
//     coefficient (c * s, the reference rounds the scaled row) to bf16 in
//     registers as the chain reads it; each chain step is an f32 multiply
//     and add, each rounded to bf16 (simple and bit-faithful to the plain
//     twin, not yet the packed __nv_bfloat162 rate).
// Built without fast math: approximate division would loosen parity.

#include "sh_device.cuh"

using namespace shk;

namespace {

constexpr int F = 64;      // packed row width
constexpr int NOUT = 24;   // output row width
constexpr int WARPS = 4;   // pairs per block

// Packed-row slots (spherharm_tpu_torch/ops/contact_kernels.py SLOTS).
enum Slot {
  XI = 0, VI = 3, QI = 6, OMI = 10, MI = 13, RBI = 14, RMI = 15, RCI = 16,
  XJ = 17, VJ = 20, QJ = 23, OMJ = 27, MJ = 30, RBJ = 31, RMJ = 32, RCJ = 33,
  HIST = 34, MASK = 40, DV = 41, TAIL = 44, MAT = 45, TYP = 53, SCL = 55
};

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

// Probe a's cap nodes against b (twin of _probe_cons). d3 = x_b - x_a.
template <bool kBf16>
__device__ Side probe_side(const float* tbl_a, float s_a, const float* tbl_b, float s_b,
                           Q4 q_a, Q4 q_b, V3 d3, float dist, float inv_dist, float rb_b,
                           float rm_a, float rb_a, const float* cap, int G, int lmax,
                           int lane) {
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

  const V3 z = v3(0.0f, 0.0f, 0.0f);
  float s1 = 0.0f, s2 = 0.0f, c_onem[2] = {0.0f, 0.0f};
  V3 cen = z, nsum = z;
  V3 g_d[2] = {z, z}, g_ta[2] = {z, z}, g_tb[2] = {z, z};
  V3 c_eb[2] = {z, z}, c_t1[2] = {z, z}, c_t2[2] = {z, z};

  // Work of this loop, counted from its body (an FMA counts 2, any other
  // arithmetic op 1; chip_smoke.py's bound reads this line):
  // node-flops[pair_contact_conservative]: 468 + 2 x radius_grad_power per node and side, 2 sides
  // node-flops[pair_contact_conservative_bf16]: 468 + 2 x radius_grad_power_bf16 per node and side, 2 sides
  for (int k = lane; k < G; k += 32) {
    const float cx = cap[k], glw = cap[G + k], cpsi = cap[2 * G + k], spsi = cap[3 * G + k];
    const float cos_g = 1.0f - one_m * cx;
    const float sin_g = sqrtf(fmaxf(1.0f - cos_g * cos_g, 1e-12f));
    const float sc = sin_g * cpsi, ss = sin_g * spsi;
    const V3 dir = cos_g * e_b + sc * t1 + ss * t2;

    float ct_a, st_a, cp_a, sp_a, r_a, drt_a, drp_a;
    unit_trig(dir, ct_a, st_a, cp_a, sp_a);
    radius_grad_power<kBf16>(tbl_a, s_a, lmax, ct_a, st_a, cp_a, sp_a, r_a, drt_a, drp_a);
    // Tangent surface gradient of r_a (a's body frame).
    const float gpa = drp_a * (1.0f / fmaxf(st_a, 1e-6f));
    const V3 ga = {drt_a * ct_a * cp_a - gpa * sp_a, drt_a * ct_a * sp_a + gpa * cp_a,
                   -drt_a * st_a};

    const float glr2 = glw * r_a * r_a;
    const float A = one_m * glr2;  // inclination-free measure
    const V3 rel = rot(q_a, r_a * dir);
    const V3 w3 = rel - d3;
    const V3 u3 = rot_inv(q_b, w3);
    const float rho = sqrtf(fmaxf(dot3(u3, u3), 1e-24f));
    const float inv_rho = 1.0f / rho;
    const V3 uh = inv_rho * u3;

    float ct_b, st_b, cp_b, sp_b, r_b, drt_b, drp_b;
    unit_trig(uh, ct_b, st_b, cp_b, sp_b);
    radius_grad_power<kBf16>(tbl_b, s_b, lmax, ct_b, st_b, cp_b, sp_b, r_b, drt_b, drp_b);
    const float gpb = drp_b * (1.0f / fmaxf(st_b, 1e-6f));
    const V3 gb = {drt_b * ct_b * cp_b - gpb * sp_b, drt_b * ct_b * sp_b + gpb * cp_b,
                   -drt_b * st_b};

    // Depth moments (no containment indicator).
    const float depth_raw = r_b - rho;
    const bool inside = depth_raw > 0.0f;
    const float D = fmaxf(depth_raw, 0.0f);
    const float wd = A * D;
    s1 += wd;
    s2 += wd * D;
    cen = cen + wd * rel;
    const V3 nb = surface_normal(r_b, drt_b, drp_b, ct_b, st_b, cp_b, sp_b);
    nsum = nsum + wd * rot(q_b, nb);

    // Gradient integrals: dD propagates through u as
    // cw . (d rel - dd + dtheta_b x w).
    const V3 cw = rot(q_b, inv_rho * gb - uh);
    const V3 crb = rot_inv(q_a, cw);
    const float crb_dot_dir = dot3(crb, dir);
    const V3 rel_x_cw = cross3(rel, cw);
    const V3 cw_x_w = cross3(cw, w3);
    const float two_gl_r = 2.0f * one_m * glw * r_a;
    const float cgs = cos_g / sin_g;
#pragma unroll
    for (int mo = 0; mo < 2; ++mo) {
      const float al = mo == 0 ? D : D * D;
      const float be = mo == 0 ? (inside ? A : 0.0f) : 2.0f * wd;
      g_d[mo] = g_d[mo] + be * cw;
      g_ta[mo] = g_ta[mo] + be * rel_x_cw;
      g_tb[mo] = g_tb[mo] + be * cw_x_w;
      const float c_ra = al * two_gl_r + be * crb_dot_dir;
      const V3 cdir = (be * r_a) * crb + c_ra * ga;
      const float cdir_dot_eb = dot3(cdir, e_b);
      const float cdir_dot_dir = dot3(cdir, dir);
      const float cdir_dot_p = (cdir_dot_dir - cos_g * cdir_dot_eb) / sin_g;
      c_eb[mo] = c_eb[mo] + cos_g * cdir;
      c_t1[mo] = c_t1[mo] + sc * cdir;
      c_t2[mo] = c_t2[mo] + ss * cdir;
      c_onem[mo] += al * glr2 - cx * (cdir_dot_eb - cgs * cdir_dot_p);
    }
  }

  Side out;
  out.s1 = warp_sum(s1);
  out.s2 = warp_sum(s2);
  out.cen = warp_sum3(cen);
  out.nsum = warp_sum3(nsum);
#pragma unroll
  for (int mo = 0; mo < 2; ++mo) {
    const V3 gd = -warp_sum3(g_d[mo]);
    V3 gta = warp_sum3(g_ta[mo]);
    const V3 gtb = warp_sum3(g_tb[mo]);
    const V3 ceb = warp_sum3(c_eb[mo]);
    const V3 ct1 = warp_sum3(c_t1[mo]);
    const V3 ct2 = warp_sum3(c_t2[mo]);
    const float conem = warp_sum(c_onem[mo]);
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

// Probe a's cap nodes against b with the inclination-weighted measure
// dA = w r_a^2 / cos_incl (twin of _probe: moments only, no gradient).
// sin_g is floored at 0 as _probe floors it (_probe_cons uses 1e-12).
template <bool kBf16>
__device__ Moments probe_side_geo(const float* tbl_a, float s_a, const float* tbl_b, float s_b,
                               Q4 q_a, Q4 q_b, V3 d3, float dist, float inv_dist, float rb_b,
                               float rm_a, float rb_a, const float* cap, int G, int lmax,
                               int lane) {
  const V3 e_b = rot_inv(q_a, inv_dist * d3);
  const float rb2 = rb_b * rb_b;
  const float rho_star = sqrtf(fmaxf(dist * dist - rb2, 0.0f));
  const float rho_c = clampf(rho_star, rm_a, rb_a);
  const float cos_gmax = clampf(
      (rho_c * rho_c + dist * dist - rb2) / fmaxf(2.0f * rho_c * dist, 1e-12f), -1.0f,
      1.0f - 1e-6f);
  const float one_m = 1.0f - cos_gmax;

  V3 h, t1, t2;
  float inv_t1;
  orthobasis(e_b, h, t1, t2, inv_t1);

  const V3 z = v3(0.0f, 0.0f, 0.0f);
  float s1 = 0.0f, s2 = 0.0f;
  V3 cen = z, nsum = z;
  // node-flops[pair_contact_geometric]: 248 + 2 x radius_grad_power per node and side, 2 sides
  // node-flops[pair_contact_geometric_bf16]: 248 + 2 x radius_grad_power_bf16 per node and side, 2 sides
  for (int k = lane; k < G; k += 32) {
    const float cx = cap[k], glw = cap[G + k], cpsi = cap[2 * G + k], spsi = cap[3 * G + k];
    const float cos_g = 1.0f - one_m * cx;
    const float sin_g = sqrtf(fmaxf(1.0f - cos_g * cos_g, 0.0f));
    const V3 dir = cos_g * e_b + (sin_g * cpsi) * t1 + (sin_g * spsi) * t2;

    float ct_a, st_a, cp_a, sp_a, r_a, drt_a, drp_a;
    unit_trig(dir, ct_a, st_a, cp_a, sp_a);
    radius_grad_power<kBf16>(tbl_a, s_a, lmax, ct_a, st_a, cp_a, sp_a, r_a, drt_a, drp_a);
    const V3 na = surface_normal(r_a, drt_a, drp_a, ct_a, st_a, cp_a, sp_a);
    const float cos_incl = clampf(dot3(dir, na), 0.05f, 1.0f);
    const float dA = one_m * glw * r_a * r_a / cos_incl;

    const V3 rel = rot(q_a, r_a * dir);
    const V3 u3 = rot_inv(q_b, rel - d3);
    const float rho = sqrtf(fmaxf(dot3(u3, u3), 1e-24f));
    const V3 uh = (1.0f / rho) * u3;
    float ct_b, st_b, cp_b, sp_b, r_b, drt_b, drp_b;
    unit_trig(uh, ct_b, st_b, cp_b, sp_b);
    radius_grad_power<kBf16>(tbl_b, s_b, lmax, ct_b, st_b, cp_b, sp_b, r_b, drt_b, drp_b);

    const float D = fmaxf(r_b - rho, 0.0f);
    const float wd = dA * D;
    s1 += wd;
    s2 += wd * D;
    cen = cen + wd * rel;
    nsum = nsum + wd * rot(q_b, surface_normal(r_b, drt_b, drp_b, ct_b, st_b, cp_b, sp_b));
  }

  return {warp_sum(s1), warp_sum(s2), warp_sum3(cen), warp_sum3(nsum)};
}

template <bool kCons, bool kBf16>
__global__ void __launch_bounds__(WARPS * 32)
    pair_contact_kernel(const float* __restrict__ packed, const float* __restrict__ tbl,
                        int T, int W, const float* __restrict__ cap, int G,
                        const float* __restrict__ par, int lmax, int P,
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

  Side a, b;  // gradients: conservative law only
  Moments ma, mb;
  if constexpr (kCons) {
    a = probe_side<kBf16>(s_tbl + ti * W, si, s_tbl + tj * W, sj, qi, qj, d, dist, inv_dist, rbj,
                   row[RMI], rbi, s_cap, G, lmax, lane);
    b = probe_side<kBf16>(s_tbl + tj * W, sj, s_tbl + ti * W, si, qj, qi, -d, dist, inv_dist, rbi,
                   row[RMJ], rbj, s_cap, G, lmax, lane);
    ma = a;
    mb = b;
  } else {
    ma = probe_side_geo<kBf16>(s_tbl + ti * W, si, s_tbl + tj * W, sj, qi, qj, d, dist, inv_dist,
                        rbj, row[RMI], rbi, s_cap, G, lmax, lane);
    mb = probe_side_geo<kBf16>(s_tbl + tj * W, sj, s_tbl + ti * W, si, qj, qi, -d, dist, inv_dist,
                        rbi, row[RMJ], rbj, s_cap, G, lmax, lane);
  }

  // Contact geometry from both sides (all lanes hold the totals).
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
#pragma unroll
    for (int c = 17; c < NOUT; ++c) o[c] = 0.0f;
  }
}

template <bool kCons, bool kBf16>
int launch(const float* packed, const float* tbl, int T, int W, const float* cap, int G,
           const float* par, int lmax, int P, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(T * W + 4 * G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_contact_kernel<kCons, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P + WARPS - 1) / WARPS;
  pair_contact_kernel<kCons, kBf16><<<blocks, WARPS * 32, smem, stream>>>(
      packed, tbl, T, W, cap, G, par, lmax, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sh_pair_contact(const float* packed, const float* tbl, int T, int W,
                               const float* cap, int G, const float* par, int lmax, int P,
                               int conservative, int bf16, float* out, cudaStream_t stream) {
  if (conservative) {
    return bf16 ? launch<true, true>(packed, tbl, T, W, cap, G, par, lmax, P, out, stream)
                : launch<true, false>(packed, tbl, T, W, cap, G, par, lmax, P, out, stream);
  }
  return bf16 ? launch<false, true>(packed, tbl, T, W, cap, G, par, lmax, P, out, stream)
              : launch<false, false>(packed, tbl, T, W, cap, G, par, lmax, P, out, stream);
}

extern "C" const char* sh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
