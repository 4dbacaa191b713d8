// Shared device helpers for the SH contact kernels (sm_90a).
//
// Counterparts of the component helpers of the reference's Pallas kernels
// (spherharm_tpu/ops/contact_pallas.py: _rot, _rot_inv, _dot3, _cross3,
// _horner, _radius_grad_power, _radius_power_ab, _surface_normal,
// _unit_trig), written per node instead of per [block, nodes] plane.
//
// The power-basis layout (spherharm_tpu_torch/ops/sh_power.py
// power_layout): per-m Horner runs, high degree first,
//   A_m  (m = 0..L, length L-m+1), B_m (m = 1..L, length L-m+1),
//   At_m (m = 0: max(L,1); m >= 1: L-m+2), Bt_m (m = 1..L, L-m+2).
// lmax is a run-time argument: each run is evaluated in the m-loop that
// consumes it, so no per-m array has to live in registers.
//
// bfloat16 variants (the reference's bf16 knobs): every bf16 operation is
// an f32 operation on bf16-valued operands, rounded once to bf16 (nearest
// even). __fmul_rn / __fadd_rn / __fsub_rn are never contracted into an
// FMA, so each multiply and each add rounds on its own. This is the
// arithmetic of PyTorch's CPU bf16 ops, which the plain twins run
// (spherharm_tpu_torch/ops/sh_power.py eval_power(bf16=True)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace shk {

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Rotate body-frame v into the world frame by unit quaternion q.
__device__ __forceinline__ V3 rot(Q4 q, V3 v) {
  const float tx = 2.0f * (q.y * v.z - q.z * v.y);
  const float ty = 2.0f * (q.z * v.x - q.x * v.z);
  const float tz = 2.0f * (q.x * v.y - q.y * v.x);
  return {v.x + q.w * tx + (q.y * tz - q.z * ty),
          v.y + q.w * ty + (q.z * tx - q.x * tz),
          v.z + q.w * tz + (q.x * ty - q.y * tx)};
}

// World -> body frame (R(q)^T v).
__device__ __forceinline__ V3 rot_inv(Q4 q, V3 v) {
  return rot({q.w, -q.x, -q.y, -q.z}, v);
}

// (cos t, sin t, cos p, sin p) of a unit vector, without angles.
__device__ __forceinline__ void unit_trig(V3 u, float& ct, float& st, float& cp,
                                          float& sp) {
  ct = clampf(u.z, -1.0f, 1.0f);
  st = sqrtf(fmaxf(u.x * u.x + u.y * u.y, 1e-24f));
  const float inv = 1.0f / fmaxf(st, 1e-12f);
  cp = u.x * inv;
  sp = u.y * inv;
}

__device__ __forceinline__ float horner(const float* t, int n, float ct) {
  float acc = t[0];
  for (int k = 1; k < n; ++k) acc = acc * ct + t[k];
  return acc;
}

// x rounded to bfloat16 (nearest even), held in a float.
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float bmul(float a, float b) { return bf(__fmul_rn(a, b)); }
__device__ __forceinline__ float badd(float a, float b) { return bf(__fadd_rn(a, b)); }
__device__ __forceinline__ float bsub(float a, float b) { return bf(__fsub_rn(a, b)); }

// Horner in bf16 over the coefficients t pre-scaled by s: each t[k] * s is
// an f32 product rounded to bf16 (the reference casts its pre-scaled rows,
// contact_pallas.py _side_tables), ct_h is already a bf16 value, and every
// multiply and add of the chain rounds to bf16.
__device__ __forceinline__ float horner_bf16(const float* t, float s, int n, float ct_h) {
  float acc = bf(__fmul_rn(t[0], s));
  for (int k = 1; k < n; ++k) acc = badd(bmul(acc, ct_h), bf(__fmul_rn(t[k], s)));
  return acc;
}

// Width of the A+B prefix and of the At block of the power layout.
__host__ __device__ __forceinline__ int ab_width(int lmax) { return (lmax + 1) * (lmax + 1); }
__host__ __device__ __forceinline__ int a_width(int lmax) { return (lmax + 1) * (lmax + 2) / 2; }
__host__ __device__ __forceinline__ int at_width(int lmax) {
  return (lmax > 1 ? lmax : 1) + lmax * (lmax + 3) / 2;
}

// (r, dr/dtheta, dr/dphi) at one node from one power-table row, for a
// particle of scale s.
//   kBf16 = false: f32 throughout, evaluated at unit scale, then scaled.
//   kBf16 = true (K3, contact_pallas.py _radius_grad_power(bf16=True)):
//     only the A/B/At/Bt Horner chains run in bf16, on the row pre-scaled
//     by s and on ct, each rounded to bf16; each chain's result returns to
//     f32, and the cos/sin(m phi) and sin^m recurrences and the m-sum stay
//     f32.
// chip_smoke.py's horner_flops counts the FLOPs of this function and of
// radius_power_ab from their loops, as a function of lmax: change both
// together.
template <bool kBf16>
__device__ __forceinline__ void radius_grad_power(const float* tbl, float s, int lmax,
                                                  float ct, float st, float cp, float sp,
                                                  float& r, float& drt, float& drp) {
  const float ct_h = kBf16 ? bf(ct) : ct;
  const auto hr = [&](int off, int n) {
    if constexpr (kBf16) {
      return horner_bf16(tbl + off, s, n, ct_h);
    } else {
      return horner(tbl + off, n, ct);
    }
  };
  int oA = 0, oB = a_width(lmax), oAt = ab_width(lmax), oBt = oAt + at_width(lmax);
  r = hr(oA, lmax + 1);
  oA += lmax + 1;
  const int n_at0 = lmax > 1 ? lmax : 1;
  drt = st * hr(oAt, n_at0);
  oAt += n_at0;
  drp = 0.0f;
  float cos_m = cp, sin_m = sp, st_m1 = 1.0f;
  for (int m = 1; m <= lmax; ++m) {
    if (m > 1) {
      const float c = cos_m * cp - sin_m * sp;
      sin_m = sin_m * cp + cos_m * sp;
      cos_m = c;
    }
    const int nab = lmax - m + 1, nt = lmax - m + 2;
    const float A = hr(oA, nab);
    const float B = hr(oB, nab);
    const float At = hr(oAt, nt);
    const float Bt = hr(oBt, nt);
    oA += nab;
    oB += nab;
    oAt += nt;
    oBt += nt;
    const float st_m = st_m1 * st;
    r = r + st_m * (cos_m * A + sin_m * B);
    drt = drt + st_m1 * (cos_m * At + sin_m * Bt);
    drp = drp + (float)m * st_m * (cos_m * B - sin_m * A);
    st_m1 = st_m;
  }
  if constexpr (!kBf16) {
    r *= s;
    drt *= s;
    drp *= s;
  }
}

// r only, at degree l, from a degree-l A/B table row (stage-1 probe), for
// a particle of scale s.
//   kBf16 = false: f32, evaluated at unit scale, then scaled.
//   kBf16 = true (K5, contact_pallas.py :841-860): the whole evaluation is
//     bf16: ct, st, cp, sp and the pre-scaled row are rounded to bf16, and
//     the Horner chains, the recurrences and the m-sum round every op.
template <bool kBf16>
__device__ __forceinline__ float radius_power_ab(const float* tbl, float s, int l, float ct,
                                                 float st, float cp, float sp) {
  // One body for both: mul/add/sub are f32 ops, or bf16-rounded ones.
  const auto mul = [](float a, float b) { return kBf16 ? bmul(a, b) : a * b; };
  const auto add = [](float a, float b) { return kBf16 ? badd(a, b) : a + b; };
  const auto sub = [](float a, float b) { return kBf16 ? bsub(a, b) : a - b; };
  if constexpr (kBf16) {
    ct = bf(ct);
    st = bf(st);
    cp = bf(cp);
    sp = bf(sp);
  }
  const auto hr = [&](int off, int n) {
    return kBf16 ? horner_bf16(tbl + off, s, n, ct) : horner(tbl + off, n, ct);
  };
  int oA = 0, oB = a_width(l);
  float r = hr(oA, l + 1);
  oA += l + 1;
  float cos_m = cp, sin_m = sp, st_m = 1.0f;
  for (int m = 1; m <= l; ++m) {
    if (m > 1) {
      const float c = sub(mul(cos_m, cp), mul(sin_m, sp));
      sin_m = add(mul(sin_m, cp), mul(cos_m, sp));
      cos_m = c;
    }
    const int nab = l - m + 1;
    const float A = hr(oA, nab);
    const float B = hr(oB, nab);
    oA += nab;
    oB += nab;
    st_m = mul(st_m, st);
    r = add(r, mul(st_m, add(mul(cos_m, A), mul(sin_m, B))));
  }
  return kBf16 ? r : r * s;
}

// Outward unit normal e_r - (r_t / r) e_t - (r_p / (r sin t)) e_p.
__device__ __forceinline__ V3 surface_normal(float r, float drt, float drp, float ct,
                                             float st, float cp, float sp) {
  const float inv_r = 1.0f / fmaxf(r, 1e-12f);
  const float inv_rs = inv_r / fmaxf(fabsf(st), 1e-6f);
  const float a = drt * inv_r;
  const float b = drp * inv_rs;
  const V3 n = {st * cp - a * ct * cp + b * sp, st * sp - a * ct * sp - b * cp, ct + a * st};
  return rsqrtf(fmaxf(dot3(n, n), 1e-24f)) * n;
}

// Orthobasis (t1, t2) around unit e: h = x-axis unless |e.x| >= 0.9,
// t1 = (e x h) / |e x h|, t2 = e x t1. Returns h (needed by gradients)
// and 1/|e x h|.
__device__ __forceinline__ void orthobasis(V3 e, V3& h, V3& t1, V3& t2, float& inv_t1) {
  const bool use_x = fabsf(e.x) < 0.9f;
  h = use_x ? v3(1.0f, 0.0f, 0.0f) : v3(0.0f, 1.0f, 0.0f);
  const V3 tau = cross3(e, h);
  inv_t1 = rsqrtf(fmaxf(dot3(tau, tau), 1e-24f));
  t1 = inv_t1 * tau;
  t2 = cross3(e, t1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ V3 warp_sum3(V3 v) {
  return {warp_sum(v.x), warp_sum(v.y), warp_sum(v.z)};
}

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ Q4 load4(const float* p) { return {p[0], p[1], p[2], p[3]}; }

// Tangential history spring with Coulomb cap + rolling spring-dashpot-
// slider, shared by the pair and wall kernels. Inputs are per-contact
// scalars; writes the new springs and returns f_t and tau_roll.
struct Material {
  float kn, kt, gn, gt, mu, k_roll, g_roll, mu_roll;
};

__device__ __forceinline__ void friction_rolling(
    V3 hist, V3 hist_r, V3 n_hat, V3 vt, bool in_contact, float poly, float fn_mag,
    float m_eff, float r_eff, V3 dom, float dt, const Material& mt, V3& xi, V3& f_t,
    V3& xi_r, V3& tau_roll) {
  xi = hist - dot3(hist, n_hat) * n_hat;
  xi = in_contact ? xi + dt * vt : v3(0.0f, 0.0f, 0.0f);
  f_t = -poly * (mt.kt * xi + (m_eff * mt.gt) * vt);
  const float ft_mag = sqrtf(fmaxf(dot3(f_t, f_t), 1e-30f));
  const float capf = mt.mu * fn_mag;
  const bool over = ft_mag > fmaxf(capf, 1e-30f);
  f_t = (over ? capf / ft_mag : 1.0f) * f_t;
  const float inv_poly = 1.0f / fmaxf(poly, 1e-30f);
  if (over && poly > 0.0f) {
    xi = -(inv_poly * f_t + (m_eff * mt.gt) * vt) / fmaxf(mt.kt, 1e-30f);
  }

  const bool roll_on = (mt.k_roll > 0.0f) || (mt.g_roll > 0.0f);
  const V3 v_roll = -r_eff * cross3(n_hat, dom);
  xi_r = hist_r - dot3(hist_r, n_hat) * n_hat;
  xi_r = (in_contact && roll_on) ? xi_r + dt * v_roll : v3(0.0f, 0.0f, 0.0f);
  V3 f_r = -(mt.k_roll * xi_r + mt.g_roll * v_roll);
  const float fr_mag = sqrtf(fmaxf(dot3(f_r, f_r), 1e-30f));
  const float cap_r = mt.mu_roll * fn_mag;
  const bool over_r = fr_mag > fmaxf(cap_r, 1e-30f);
  f_r = (over_r ? cap_r / fr_mag : 1.0f) * f_r;
  if (over_r && mt.k_roll > 0.0f) {
    xi_r = -(f_r + mt.g_roll * v_roll) / fmaxf(mt.k_roll, 1e-30f);
  }
  tau_roll = in_contact ? r_eff * cross3(n_hat, f_r) : v3(0.0f, 0.0f, 0.0f);
}

}  // namespace shk
