// Stage-2 SH pair contact, hand-written for sm_90a: the C entry of both
// elastic laws, and the geometric law's kernel.
//
// Replaces: spherharm_tpu/ops/contact_pallas.py pair_contact_pallas ->
//   _make_kernel(lmax, conservative=False) with _probe (K2: the geometric
//   law, inclination-weighted measure, force along the integral normal at
//   the centroid); kBf16 = true is K3 geometric, _make_kernel(lmax,
//   conservative=False, bf16=True): the Horner chains of every surface
//   evaluation in bfloat16 on the pre-scaled table rows, the assembly in
//   f32 (sh_device.cuh radius_grad_power<true>). The conservative law (K1,
//   K3 conservative) is pair_contact_cons.cu; sh_pair_contact below picks
//   the law.
//
// What bounds it on this card: arithmetic. Per pair it evaluates 2 sides
// x G cap nodes x 2 power-basis surface evaluations (441 FLOP each at
// lmax 8, chip_smoke.horner_flops) plus ~250 FLOP a node of probe and
// normal algebra, against 64 + 24 floats of traffic per pair. The design:
//   * one warp per pair, lanes striding over the cap nodes (any G: 128 at
//     8x16, 288 at the deposition's 12x24);
//   * the per-type power table (T x W floats, ~5.7 KB at T = 8, lmax 8)
//     and the cap grid (4 G floats) live in shared memory, indexed by the
//     type id carried in the packed row (the TPU's one-hot matmul gather
//     has no reason to exist here);
//   * the 8 per-side sums (s1, s2, centroid, normal) are reduced with xor
//     shuffles, so every lane ends with the totals; the pair-level
//     epilogue (pair_contact.cuh) runs redundantly on all lanes and lane 0
//     writes the 24-float row;
//   * a masked row (mask <= 0.5) writes zeros and skips the body;
//   * lmax is a run-time argument and every Horner chain a loop over the
//     shared table; K3 rounds each pre-scaled coefficient to bf16 in
//     registers as the chain reads it.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, on
// 16,384 contact-rich pairs at lmax 8: K2 1.60 ms at 288 nodes against its
// 0.156 ms bound (10 %), K3 geometric 2.95 ms against 0.117 (4 %). The
// conservative kernel's redesign (pair_contact_cons.cu: compile-time
// degree, node-blocked chains, packed bf16 chains) has not been carried
// over to this law yet.
// Built without fast math: approximate division would loosen parity.

#include "pair_contact.cuh"

using namespace shk;

namespace {

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

template <bool kBf16>
__global__ void __launch_bounds__(WARPS * 32)
    pair_geometric_kernel(const float* __restrict__ packed, const float* __restrict__ tbl,
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

  const Moments ma = probe_side_geo<kBf16>(s_tbl + ti * W, si, s_tbl + tj * W, sj, qi, qj, d,
                                           dist, inv_dist, rbj, row[RMI], rbi, s_cap, G, lmax,
                                           lane);
  const Moments mb = probe_side_geo<kBf16>(s_tbl + tj * W, sj, s_tbl + ti * W, si, qj, qi, -d,
                                           dist, inv_dist, rbi, row[RMJ], rbj, s_cap, G, lmax,
                                           lane);
  const Side none{};
  pair_epilogue<false>(row, ma, mb, none, none, d, dist, inv_dist, rbi, rbj, par, lane, o);
}

template <bool kBf16>
int launch_geometric(const float* packed, const float* tbl, int T, int W, const float* cap,
                     int G, const float* par, int lmax, int P, float* out,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(T * W + 4 * G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_geometric_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P + WARPS - 1) / WARPS;
  pair_geometric_kernel<kBf16><<<blocks, WARPS * 32, smem, stream>>>(packed, tbl, T, W, cap, G,
                                                                     par, lmax, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sh_pair_contact(const float* packed, const float* tbl, int T, int W,
                               const float* cap, int G, const float* par, int lmax, int P,
                               int conservative, int bf16, float* out, cudaStream_t stream) {
  if (conservative) {
    return launch_pair_conservative(packed, tbl, T, W, cap, G, par, lmax, P, bf16 != 0, out,
                                    stream);
  }
  return bf16 ? launch_geometric<true>(packed, tbl, T, W, cap, G, par, lmax, P, out, stream)
              : launch_geometric<false>(packed, tbl, T, W, cap, G, par, lmax, P, out, stream);
}

extern "C" const char* sh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
