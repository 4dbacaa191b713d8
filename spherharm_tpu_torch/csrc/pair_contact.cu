// Stage-2 SH pair contact, hand-written for sm_90a: the C entry of both
// elastic laws, and the geometric law's kernel.
//
// Replaces: spherharm_tpu/ops/contact_pallas.py pair_contact_pallas ->
//   _make_kernel(lmax, conservative=False) with _probe (K2: the geometric
//   law, inclination-weighted measure, force along the integral normal at
//   the centroid); kBf16 = true is K3 geometric, _make_kernel(lmax,
//   conservative=False, bf16=True): the Horner chains of every surface
//   evaluation in bfloat16 on the pre-scaled table rows, the assembly in
//   f32 (the arithmetic of sh_device.cuh radius_grad_power<true>). The
//   conservative law (K1, K3 conservative) is pair_contact_cons.cu;
//   sh_pair_contact_indexed below picks the law.
//
// What bounds it on this card: arithmetic. Per pair it evaluates 2 sides
// x G cap nodes x 2 power-basis surface evaluations (441 FLOP each at
// lmax 8, chip_smoke.horner_flops) plus 248 FLOP a node of probe and
// normal algebra, against 64 + 24 floats of traffic per pair. The design
// is the conservative kernel's (pair_contact_cons.cu), with the helpers
// it shares in pair_contact.cuh and sh_nodes.cuh:
//   * one warp per pair, lanes striding over the cap nodes (any G: 128 at
//     8x16, 288 at the deposition's 12x24); the per-type power table and
//     the cap grid in shared memory, indexed by the type id carried in
//     the packed row (the TPU's one-hot matmul gather has no reason to
//     exist here);
//   * the degree is a template parameter L (with_degree: 0, 2, 4, 8
//     compiled, any other lmax L = -1, read at run time): every Horner
//     run's offset and length is a compile-time constant and the chains
//     unroll fully;
//   * a lane evaluates NB of its cap nodes together (radius_grad_nodes):
//     each shared-memory coefficient load feeds NB FMAs and the A, B, At
//     and Bt chains of one m run side by side. Side b's evaluation needs
//     side a's radius at the same node, so the NB a-evaluations run
//     first, then the NB b-evaluations. NB is 2, or 3 in f32 where that
//     leaves fewer idle node slots (launch_geometric: the deposition's 288
//     nodes fill 3 blocks of 96, where blocks of 64 leave the fifth half
//     empty); where G is not a multiple of 32 NB the last block repeats a
//     valid node, which adds nothing;
//   * the table loads stay in the node loop, behind an offset the
//     compiler cannot see through (at a fixed degree it would hoist them
//     all and spill them to local memory);
//   * K3 builds each side's pre-scaled row bf(t[k] s) once per warp in
//     shared memory, in both halves of a __nv_bfloat162 (bf16_rows), and
//     runs two nodes' chain steps per instruction with __hmul2_rn /
//     __hadd2_rn, never fused: the bits of the twin's "f32 op, then round
//     to bf16". The recurrences and the m-sum stay f32;
//   * the 8 per-side sums (s1, s2, centroid, normal) reduce with xor
//     shuffles, so every lane ends with the totals; the pair-level
//     epilogue (pair_contact.cuh) runs redundantly on all lanes and lane 0
//     writes the 24-float row; a masked row (mask <= 0.5) writes zeros;
//   * one entry, sh_pair_contact_indexed, reads the pair list by index
//     (IndexedRows, pair_contact.cuh): each warp gathers its pair's row
//     into shared memory from the [N, 20] particle rows, the pair indices,
//     the springs, the material table and the box, and forms the mask and
//     the triclinic minimum image itself, so no [P, 64] tensor is built. A
//     block of four dead slots writes its zero rows and stages nothing:
//     a list's live slots are a prefix of it, most of a sheared cell's
//     1.2M-slot list is its dead tail.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, on
// 16,384 contact-rich pairs at Lmax 8 and 288 nodes: K2 0.49 ms against
// its 0.156 ms bound (32 %), K3 geometric 0.61 ms against 0.117 (19 %).
// The Lmax-8 f32 node loop issues 1,005 instructions a node and side
// (3-node blocks), 1.78x the issue slots the bound counts.
// Built without fast math: approximate division would loosen parity.

#include "pair_contact.cuh"

using namespace shk;

namespace {

// Blocks an SM must hold (__launch_bounds__): at most 65536 / (128 x 3)
// = 170 registers a thread. Every instantiation fits without a spill
// (85-168; at Lmax 8: 117 f32, 128 f32 3-node, 110 bf16); 4 blocks (128)
// spill the run-time-degree 3-node kernel.
constexpr int MIN_BLOCKS = 3;

// Probe a's cap nodes against b with the inclination-weighted measure
// dA = w r_a^2 / cos_incl (twin of _probe: moments only, no gradient).
// sin_g is floored at 0 as _probe floors it (_probe_cons uses 1e-12).
template <int L, bool kBf16, int NB>
__device__ __forceinline__ Moments probe_side_geo(const Coef<kBf16>* tbl_a, float s_a,
                                                  const Coef<kBf16>* tbl_b, float s_b, Q4 q_a,
                                                  Q4 q_b, V3 d3, float dist, float inv_dist,
                                                  float rb_b, float rm_a, float rb_a,
                                                  const float* cap, int G, int lmax,
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
    float glw[NB];
    V3 dir[NB];
    float ct[NB], st[NB], cp[NB], sp[NB], r_a[NB], drt_a[NB], drp_a[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int k = k0 + 32 * j;
      valid[j] = k < G;
      const int kc = valid[j] ? k : k0;
      const float cx = cap[kc], cpsi = cap[2 * G + kc], spsi = cap[3 * G + kc];
      glw[j] = cap[G + kc];
      const float cos_g = 1.0f - one_m * cx;
      const float sin_g = sqrtf(fmaxf(1.0f - cos_g * cos_g, 0.0f));
      dir[j] = cos_g * e_b + (sin_g * cpsi) * t1 + (sin_g * spsi) * t2;
      unit_trig(dir[j], ct[j], st[j], cp[j], sp[j]);
    }
    radius_grad_nodes<L, kBf16, NB>(ta, s_a, lmax, ct, st, cp, sp, r_a, drt_a, drp_a);

    float dA[NB], rho[NB];
    V3 rel[NB];
    float ct_b[NB], st_b[NB], cp_b[NB], sp_b[NB], r_b[NB], drt_b[NB], drp_b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const V3 na = surface_normal(r_a[j], drt_a[j], drp_a[j], ct[j], st[j], cp[j], sp[j]);
      const float cos_incl = clampf(dot3(dir[j], na), 0.05f, 1.0f);
      dA[j] = one_m * glw[j] * r_a[j] * r_a[j] / cos_incl;
      rel[j] = rot(q_a, r_a[j] * dir[j]);
      const V3 u3 = rot_inv(q_b, rel[j] - d3);
      rho[j] = sqrtf(fmaxf(dot3(u3, u3), 1e-24f));
      const V3 uh = (1.0f / rho[j]) * u3;
      unit_trig(uh, ct_b[j], st_b[j], cp_b[j], sp_b[j]);
    }
    radius_grad_nodes<L, kBf16, NB>(tb, s_b, lmax, ct_b, st_b, cp_b, sp_b, r_b, drt_b,
                                    drp_b);

#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!valid[j]) continue;
      const float D = fmaxf(r_b[j] - rho[j], 0.0f);
      const float wd = dA[j] * D;
      s1 += wd;
      s2 += wd * D;
      cen = cen + wd * rel[j];
      nsum = nsum + wd * rot(q_b, surface_normal(r_b[j], drt_b[j], drp_b[j], ct_b[j], st_b[j],
                                                 cp_b[j], sp_b[j]));
    }
  }

  return {warp_sum(s1), warp_sum(s2), warp_sum3(cen), warp_sum3(nsum)};
}

template <int L, bool kBf16, int NB>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    pair_geometric_kernel(const IndexedRows in, const float* __restrict__ tbl, int T, int W,
                          const float* __restrict__ cap, int G, const float* __restrict__ par,
                          int lmax, int P, int rpr, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  IndexedRows::Slot slot{};
  if (p < P) slot = in.slot(p);
  float* o = out + (size_t)p * NOUT;
  // A dead slot writes zeros; a block of dead slots (a list's dead tail)
  // stages nothing.
  if (!__syncthreads_or(slot.valid)) {
    if (p < P && lane < NOUT) o[lane] = 0.0f;
    return;
  }
  float* s_tbl = smem;                    // [T, W] power table
  float* s_cap = s_tbl + T * W;           // [4, G] cap grid
  float* s_row = s_cap + 4 * G;           // [WARPS, F] gathered rows
  float* s_bf = s_row + WARPS * F;        // [WARPS, 2, W] bf16 rows (kBf16)
  // The table and the cap grid arrive while the warps gather their rows.
  stage_async(s_tbl, tbl, T * W);
  stage_async(s_cap, cap, 4 * G);
  __pipeline_commit();
  const float* row = s_row + warp * F;
  const bool live = slot.valid && in.gather(p, slot, s_row + warp * F, lane);
  __pipeline_wait_prior(0);
  __syncthreads();

  if (!live) {
    if (p < P && lane < NOUT) o[lane] = 0.0f;
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

  Moments ma, mb;
  if constexpr (kBf16) {
    // This warp's two pre-scaled rows.
    __nv_bfloat162* tb = reinterpret_cast<__nv_bfloat162*>(s_bf) + warp * 2 * W;
    bf16_rows(s_tbl + ti * W, si, s_tbl + tj * W, sj, W, lane, tb);
    ma = probe_side_geo<L, true, NB>(tb, si, tb + W, sj, qi, qj, d, dist, inv_dist, rbj,
                                     row[RMI], rbi, s_cap, G, lmax, lane);
    mb = probe_side_geo<L, true, NB>(tb + W, sj, tb, si, qj, qi, -d, dist, inv_dist, rbi,
                                     row[RMJ], rbj, s_cap, G, lmax, lane);
  } else {
    ma = probe_side_geo<L, false, NB>(s_tbl + ti * W, si, s_tbl + tj * W, sj, qi, qj, d, dist,
                                      inv_dist, rbj, row[RMI], rbi, s_cap, G, lmax, lane);
    mb = probe_side_geo<L, false, NB>(s_tbl + tj * W, sj, s_tbl + ti * W, si, qj, qi, -d,
                                      dist, inv_dist, rbi, row[RMJ], rbj, s_cap, G, lmax, lane);
  }
  const Side none{};
  pair_epilogue<false>(row, ma, mb, none, none, d, dist, inv_dist, rbi, rbj,
                       replica_par(par, rpr), lane, o);
}

int launch_geometric(const IndexedRows& in, const float* tbl, int T, int W, const float* cap,
                     int G, const float* par, int lmax, int P, int rpr, bool bf16,
                     float* out, cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)(T * W + 4 * G + WARPS * F);
  if (bf16) smem += sizeof(__nv_bfloat162) * (size_t)(WARPS * 2 * W);
  // 3 nodes a block where that spans fewer slots than 2 (f32 only: the
  // bf16 chains run the nodes in pairs).
  const bool nb3 = !bf16 && node_slots(G, 3) < node_slots(G, 2);
  return with_degree(lmax, [&](auto degree) {
    constexpr int L = decltype(degree)::value;
    const PairKernel kernel = bf16  ? pair_geometric_kernel<L, true, 2>
                              : nb3 ? pair_geometric_kernel<L, false, 3>
                                    : pair_geometric_kernel<L, false, 2>;
    return launch_pairs(kernel, smem, in, tbl, T, W, cap, G, par, lmax, P, rpr, out, stream);
  });
}

}  // namespace

// The law over the pair list by index (IndexedRows): P = RL ppl slots of
// RL lists, each list's particles N rows of rows and typ; the output row
// also carries d (columns 17-19) and the mask (column 20). par [P / rpr,
// 16]: the rows of P / rpr replicas, rpr rows each, replica-major; a row
// reads its replica's par row (rpr = P: one list).
extern "C" int sh_pair_contact_indexed(
    const float* rows, const long long* typ, int N, const long long* pi, const long long* pj,
    const unsigned char* valid, const float* hist, int hist_stride, const float* tab, int tp,
    int tab_rep, const float* box, int box_w, int px, int py, int pz, int ppl,
    const float* tbl, int T, int W, const float* cap, int G, const float* par, int lmax, int P,
    int rpr, int conservative, int bf16, float* out, cudaStream_t stream) {
  if (ppl < 1 || N < 1 || tp < 1 || (box_w != 3 && box_w != 6) || rpr < 1)
    return (int)cudaErrorInvalidValue;
  const IndexedRows in{rows, typ,         pi, pj,      valid, hist, tab, box, N,
                       ppl,  hist_stride, tp, tab_rep, box_w, px,   py,  pz};
  return (conservative ? launch_pair_conservative : launch_geometric)(
      in, tbl, T, W, cap, G, par, lmax, P, rpr, bf16 != 0, out, stream);
}

extern "C" const char* sh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
