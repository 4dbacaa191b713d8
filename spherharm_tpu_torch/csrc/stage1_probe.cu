// Stage-1 r-only containment probe, hand-written for sm_90a.
//
// Replaces: spherharm_tpu/ops/contact_pallas.py
//   stage1_depth_pallas -> _make_stage1_kernel(lmax, l1, bf16), every
//   variant: K4 (l1 = lmax, bf16 = False, the full-basis f32 probe the
//   rebuild-time prefilter runs) and K5 (l1 < lmax and/or bf16 = True,
//   the function's own defaults l1 = 4, bf16 = True). The surface is
//   evaluated at degree l1 from a degree-l1 table; bf16 is the template
//   parameter kBf16 (the whole radius evaluation in bfloat16, as
//   sh_device.cuh radius_power_ab<true> rounds it).
//
// Per candidate pair it writes an upper bound on the max signed node depth
// (r_target - rho) over both probe directions on the coarse cap1 grid,
// plus the packed tail column (the truncation bound beyond degree l1),
// plus 0.02 (rb_i + rb_j) with bf16 (the reference's rounding margin);
// pairs apart by their bounding spheres give rsum - dist, dead rows -1e9.
//
// What bounds it on this card: the rows it must read, and the arithmetic
// of the probed ones. A candidate list is mostly dead (masked) or
// sphere-separated rows, which need one or three 32-byte sectors of their
// 256-byte row; only the probed rows (bounding spheres overlapping) run
// the surface: at Lmax 8, 2 sides x 32 nodes x 540 FLOP a row.
// Design:
//   * rows are sorted out by thread, probed by warp: a block takes a tile
//     of rows, one a thread; each thread reads its row's mask and d (one
//     16-byte load) and, if live, rb_i and rb_j, writes the dead and
//     separated rows' outputs itself and appends a probed row's index to
//     a shared-memory queue (a warp ballot, one shared atomic a warp);
//     the warps then drain the queue. A dead row costs one thread;
//   * a grid of about SMs x blocks-an-SM blocks strides over the tiles
//     (a tile shrinks to at most 256 rows so that short lists still fill
//     the card), so each block stages the unit-scale [T8, W] table and the
//     [4, G] cap grid in shared memory once for many rows;
//   * a warp probes two rows at a time, half a warp a row: in each half,
//     lanes 0-7 take side ij (i's cap nodes against j's surface), lanes
//     8-15 side ji, each lane NB = 2 nodes a pass (G = 32: two passes),
//     and one max over the half reduces both sides;
//   * the degree is a template parameter L (with_degree: 0, 2, 4, 8
//     compiled, any other l1 L = -1, read at run time): K4 runs L = 8 on
//     every prefiltered path, K5 L = 4; the chains unroll fully and each
//     shared-memory coefficient load feeds NB nodes (sh_nodes.cuh
//     radius_ab_nodes). The table loads stay in the node loop behind an
//     offset the compiler cannot see through (at a fixed degree it would
//     hoist them and spill);
//   * bf16 (K5): each probed pair's two rows, pre-scaled and rounded to
//     bf16, are built once in shared memory by the warp; the chains, the
//     recurrences and the m-sum run two nodes a packed __hmul2_rn /
//     __hadd2_rn instruction, bit for bit the twin's per-op rounding.
// Compiled for L in {0, 2, 4, 8, -1} x {f32, bf16}. Launched on the card:
// f32 at L = 8 (K4, chip_smoke.py and the card tests), 4 (K5) and, in
// tests/test_torch_cuda.py, 0, 2 and -1 (lmax 6); bf16 at L = 4 (K5) and
// 2 (the card tests). bf16 at L = 0, 8 and -1 is compiled, never launched.
// Measured by device time over 20 launches (the variant timing in PERF.md
// section 6) on an NVIDIA H100 80GB HBM3 at 700.00 W, two rows a warp: K4
// 0.0209 ms on the drum's 500,000-slot candidate list (none probed; bound
// 0.0069 ms by bytes; 6.3x faster than the warp-a-row kernel this
// replaces), 0.0211 ms on the 16,384-pair batch (2.7x), 0.0281 ms on the
// drift gas's 60,000-slot list (2.0x); K5 there 0.0185 ms f32, 0.0195 ms
// bf16 (1.8x, 2.5x). 80 registers at most, no spill.
// Built without fast math: approximate division would loosen parity.

#include <math.h>

#include "sh_nodes.cuh"

using namespace shk;

namespace {

constexpr int F = 64;
constexpr int THREADS = 256;  // at most one tile of rows, one a thread
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2;                // probed rows a warp takes at a time
constexpr int LPR = 32 / ROWS;         // lanes a row
constexpr int LPS = LPR / 2;           // lanes a side
constexpr int NB = 2;                  // cap nodes a lane evaluates together
// Blocks an SM must hold (__launch_bounds__): at most 65536 / (256 x 3) =
// 85 registers a thread.
constexpr int MIN_BLOCKS = 3;
enum Slot { QI = 6, RBI = 14, RMI = 15, QJ = 23, RBJ = 31, RMJ = 32, MASK = 40, DV = 41,
            TAIL = 44, TYP = 53, SCL = 55 };

// Max over this lane's cap nodes of a (k_lane + LPS j, j < NB, then
// striding) of (r_b(u) - rho); d3 = x_b - x_a. f32 rows t_a, t_b are at
// unit scale (scaled by s_a, s_b), bf16 rows pre-scaled.
template <int L, bool kBf16>
__device__ __forceinline__ float probe_side(const Coef<kBf16>* t_a, float s_a,
                                            const Coef<kBf16>* t_b, float s_b, Q4 q_a, Q4 q_b,
                                            V3 d3, float dist, float inv_dist, float rb_b,
                                            float rm_a, float rb_a, const float* cap, int G,
                                            int l1, int k_lane) {
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
  for (int k0 = k_lane; k0 < G; k0 += LPS * NB) {
    // The rows do not change in this loop, and with the degree known the
    // compiler would hoist their loads out of it into registers that
    // spill. An offset it cannot see through keeps them in shared memory.
    int off = 0;
    asm volatile("" : "+r"(off));
    // Node j of this block is k0 + LPS j; one past G repeats node k0,
    // which leaves the max as it is.
    V3 dir[NB];
    float ct[NB], st[NB], cp[NB], sp[NB], r[NB], rho[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int k = k0 + LPS * j < G ? k0 + LPS * j : k0;
      const float cos_g = 1.0f - one_m * cap[k];
      const float sin_g = sqrtf(fmaxf(1.0f - cos_g * cos_g, 0.0f));
      dir[j] = cos_g * e_b + (sin_g * cap[2 * G + k]) * t1 + (sin_g * cap[3 * G + k]) * t2;
      unit_trig(dir[j], ct[j], st[j], cp[j], sp[j]);
    }
    radius_ab_nodes<L, kBf16, NB>(t_a + off, s_a, l1, ct, st, cp, sp, r);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const V3 u = rot_inv(q_b, rot(q_a, r[j] * dir[j]) - d3);
      rho[j] = sqrtf(fmaxf(dot3(u, u), 1e-24f));
      unit_trig((1.0f / rho[j]) * u, ct[j], st[j], cp[j], sp[j]);
    }
    radius_ab_nodes<L, kBf16, NB>(t_b + off, s_b, l1, ct, st, cp, sp, r);
#pragma unroll
    for (int j = 0; j < NB; ++j) best = fmaxf(best, r[j] - rho[j]);
  }
  return best;
}

template <int L, bool kBf16>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    stage1_kernel(const float* __restrict__ packed, const float* __restrict__ tbl, int T,
                  int W, const float* __restrict__ cap, int G, int l1, int P, int tile_rows,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_tbl = smem;                                 // [T, W] unit-scale table
  float* s_cap = s_tbl + T * W;                        // [4, G] cap1 grid
  int* s_queue = reinterpret_cast<int*>(s_cap + 4 * G);  // probed rows of a tile
  // bf16: each warp's pairs' two pre-scaled rows, [WARPS, ROWS, 2, W].
  __nv_bfloat162* s_rows = reinterpret_cast<__nv_bfloat162*>(s_queue + THREADS);
  __shared__ int s_count[2];
  for (int i = threadIdx.x; i < T * W; i += THREADS) s_tbl[i] = tbl[i];
  for (int i = threadIdx.x; i < 4 * G; i += THREADS) s_cap[i] = cap[i];
  if (threadIdx.x == 0) s_count[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (P + tile_rows - 1) / tile_rows;
  int par = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, par ^= 1) {
    // Sort the tile's rows out, one a thread.
    const int p = tile * tile_rows + threadIdx.x;
    bool probed = false;
    if (threadIdx.x < tile_rows && p < P) {
      const float* row = packed + (size_t)p * F;
      const float4 md = *reinterpret_cast<const float4*>(row + MASK);  // mask, d
      const V3 d = v3(md.y, md.z, md.w);
      const float dist = sqrtf(fmaxf(dot3(d, d), 1e-24f));
      if (!(md.x > 0.5f && dist > 1e-12f)) {
        out[p] = -1e9f;
      } else {
        const float rsum = row[RBI] + row[RBJ];
        // Not probed (the cap geometry assumes dist < rsum), but surfaces
        // lie inside the bounding spheres, so rsum - dist bounds the depth.
        if (!(dist < rsum)) {
          out[p] = rsum - dist;
        } else {
          probed = true;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, probed);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_count[par], __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (probed) s_queue[base + __popc(ballot & ((1u << lane) - 1u))] = p;
    __syncthreads();
    const int n = s_count[par];
    if (threadIdx.x == 0) s_count[par ^ 1] = 0;

    // Probe the queued rows, ROWS rows a warp at a time, LPR lanes a row.
    for (int i0 = warp * ROWS; i0 < n; i0 += WARPS * ROWS) {
      const int i = i0 + lane / LPR;
      const bool own = i < n;  // else repeat row i0, write nothing
      const int q = s_queue[own ? i : i0];
      const float* row = packed + (size_t)q * F;
      const V3 d = load3(row + DV);
      const float dist = sqrtf(fmaxf(dot3(d, d), 1e-24f));
      const float inv_dist = 1.0f / dist;
      const float rbi = row[RBI], rbj = row[RBJ];
      const int ti = min(max((int)row[TYP], 0), T - 1);
      const int tj = min(max((int)row[TYP + 1], 0), T - 1);
      const float si = row[SCL], sj = row[SCL + 1];
      const bool ji = (lane % LPR) >= LPS;  // this lane's side: j's cap probes i
      const Coef<kBf16>*t_i, *t_j;
      if constexpr (kBf16) {
        __nv_bfloat162* rows = s_rows + (warp * ROWS + lane / LPR) * 2 * W;
        for (int k = lane % LPR; k < W; k += LPR) {
          rows[k] = __bfloat162bfloat162(__float2bfloat16_rn(__fmul_rn(s_tbl[ti * W + k], si)));
          rows[W + k] =
              __bfloat162bfloat162(__float2bfloat16_rn(__fmul_rn(s_tbl[tj * W + k], sj)));
        }
        __syncwarp();
        t_i = rows;
        t_j = rows + W;
      } else {
        t_i = s_tbl + ti * W;
        t_j = s_tbl + tj * W;
      }
      float best = probe_side<L, kBf16>(
          ji ? t_j : t_i, ji ? sj : si, ji ? t_i : t_j, ji ? si : sj,
          load4(row + (ji ? QJ : QI)), load4(row + (ji ? QI : QJ)), ji ? -d : d, dist,
          inv_dist, ji ? rbi : rbj, row[ji ? RMJ : RMI], ji ? rbj : rbi, s_cap, G, l1,
          lane % LPS);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
      if (own && lane % LPR == 0) {
        float depth = best + row[TAIL];
        if (kBf16) depth += 0.02f * (rbi + rbj);
        out[q] = depth;
      }
      if constexpr (kBf16) __syncwarp();  // the rows are rebuilt for the next pair
    }
    __syncthreads();  // the queue is refilled for the next tile
  }
}

using Stage1Kernel = void (*)(const float*, const float*, int, int, const float*, int, int,
                              int, int, float*);

template <bool kBf16>
int launch(const float* packed, const float* tbl1, int T, int W, const float* cap1, int G,
           int l1, int P, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(T * W + 4 * G + THREADS) +
                      (kBf16 ? sizeof(__nv_bfloat162) * (size_t)(WARPS * ROWS * 2 * W) : 0);
  return with_degree(l1, [&](auto degree) {
    constexpr int L = decltype(degree)::value;
    const Stage1Kernel kernel = stage1_kernel<L, kBf16>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
            cudaSuccess)
      return (int)e;
    // Tiles of a multiple of 32 rows, at most THREADS, small enough that
    // the list gives every resident block a tile where it can.
    const int slots = sms * (per_sm > 0 ? per_sm : 1);
    const int tile_rows = min(THREADS, ((P + slots - 1) / slots + 31) / 32 * 32);
    const int tiles = (P + tile_rows - 1) / tile_rows;
    const int blocks = min(tiles, slots);
    kernel<<<blocks, THREADS, smem, stream>>>(packed, tbl1, T, W, cap1, G, l1, P, tile_rows,
                                              out);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// tbl1: [T, (l1+1)^2] degree-l1 A/B table rows at unit scale (W = (l1+1)^2).
extern "C" int sh_stage1_depth(const float* packed, const float* tbl1, int T, int W,
                               const float* cap1, int G, int l1, int bf16, int P, float* out,
                               cudaStream_t stream) {
  return bf16 ? launch<true>(packed, tbl1, T, W, cap1, G, l1, P, out, stream)
              : launch<false>(packed, tbl1, T, W, cap1, G, l1, P, out, stream);
}
