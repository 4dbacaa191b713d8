// The node-blocked surface evaluation at a compile-time degree, shared by
// the stage-2 pair kernels (pair_contact.cuh, pair_contact.cu,
// pair_contact_cons.cu) and the wall kernel (wall_contact.cu): a lane
// evaluates N of its cap nodes together, so each coefficient load feeds N
// FMAs; the degree switch that picks the compiled instantiation; the node
// slots a lane's blocks span.
#pragma once

#include <type_traits>

#include "sh_device.cuh"

namespace shk {

template <bool kBf16>
using Coef = std::conditional_t<kBf16, __nv_bfloat162, float>;

// N nodes' Horner accumulators: f32, or bf16 pairs (two nodes an
// instruction).
template <int N, bool kBf16>
struct Nodes;

template <int N>
struct Nodes<N, false> {
  float v[N];
  __device__ __forceinline__ void set(float c) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = c;
  }
  __device__ __forceinline__ void step(const Nodes& x, float c) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = v[j] * x.v[j] + c;
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
};

template <int N>
struct Nodes<N, true> {
  static_assert(N % 2 == 0, "bf16 chains run the nodes in pairs");
  __nv_bfloat162 v[N / 2];
  __device__ __forceinline__ void set(__nv_bfloat162 c) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) v[i] = c;
  }
  __device__ __forceinline__ void step(const Nodes& x, __nv_bfloat162 c) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) v[i] = __hadd2_rn(__hmul2_rn(v[i], x.v[i]), c);
  }
  __device__ __forceinline__ float get(int j) const {
    return (j & 1) ? __high2float(v[j / 2]) : __low2float(v[j / 2]);
  }
};

template <int N, bool kBf16>
__device__ __forceinline__ Nodes<N, kBf16> horner_nodes(const Coef<kBf16>* t, int n,
                                                        const Nodes<N, kBf16>& x) {
  Nodes<N, kBf16> acc;
  acc.set(t[0]);
#pragma unroll
  for (int k = 1; k < n; ++k) acc.step(x, t[k]);
  return acc;
}

// (r, dr/dtheta, dr/dphi) at N nodes from one power-table row: the
// arithmetic of sh_device.cuh radius_grad_power<kBf16> node for node, at
// degree L (L = -1: lmax). f32 rows are at unit scale (scaled by s at
// the end); bf16 rows are pre-scaled (bf16_rows).
template <int L, bool kBf16, int N>
__device__ __forceinline__ void radius_grad_nodes(const Coef<kBf16>* t, float s, int lmax,
                                                  const float (&ct)[N], const float (&st)[N],
                                                  const float (&cp)[N], const float (&sp)[N],
                                                  float (&r)[N], float (&drt)[N],
                                                  float (&drp)[N]) {
  const int lm = L >= 0 ? L : lmax;
  Nodes<N, kBf16> x;
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x.v[i] = __floats2bfloat162_rn(ct[2 * i], ct[2 * i + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x.v[j] = ct[j];
  }
  const int n_at0 = lm > 1 ? lm : 1;
  const Nodes<N, kBf16> a0 = horner_nodes<N, kBf16>(t, lm + 1, x);
  const Nodes<N, kBf16> at0 = horner_nodes<N, kBf16>(t + ab_width(lm), n_at0, x);
  float cos_m[N], sin_m[N], st_m1[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    r[j] = a0.get(j);
    drt[j] = st[j] * at0.get(j);
    drp[j] = 0.0f;
    cos_m[j] = cp[j];
    sin_m[j] = sp[j];
    st_m1[j] = 1.0f;
  }
  int oA = lm + 1, oB = a_width(lm), oAt = ab_width(lm) + n_at0;
  int oBt = ab_width(lm) + at_width(lm);
#pragma unroll
  for (int m = 1; m <= lm; ++m) {
    // A_m, B_m (nab coefficients) and At_m, Bt_m (nab + 1), side by side.
    const int nab = lm - m + 1;
    Nodes<N, kBf16> A, B, At, Bt;
    A.set(t[oA]);
    B.set(t[oB]);
    At.set(t[oAt]);
    Bt.set(t[oBt]);
#pragma unroll
    for (int k = 1; k < nab; ++k) {
      A.step(x, t[oA + k]);
      B.step(x, t[oB + k]);
      At.step(x, t[oAt + k]);
      Bt.step(x, t[oBt + k]);
    }
    At.step(x, t[oAt + nab]);
    Bt.step(x, t[oBt + nab]);
    oA += nab;
    oB += nab;
    oAt += nab + 1;
    oBt += nab + 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (m > 1) {
        const float c = cos_m[j] * cp[j] - sin_m[j] * sp[j];
        sin_m[j] = sin_m[j] * cp[j] + cos_m[j] * sp[j];
        cos_m[j] = c;
      }
      const float st_m = st_m1[j] * st[j];
      r[j] = r[j] + st_m * (cos_m[j] * A.get(j) + sin_m[j] * B.get(j));
      drt[j] = drt[j] + st_m1[j] * (cos_m[j] * At.get(j) + sin_m[j] * Bt.get(j));
      drp[j] = drp[j] + (float)m * st_m * (cos_m[j] * B.get(j) - sin_m[j] * A.get(j));
      st_m1[j] = st_m;
    }
  }
  if constexpr (!kBf16) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      r[j] *= s;
      drt[j] *= s;
      drp[j] *= s;
    }
  }
}

// The arithmetic of N nodes' values, one element a node (f32) or a node
// pair (bf16): every bf16 multiply and add rounds once, never fused, as
// the twins round each op.
template <bool kBf16>
struct NodeOps;

template <>
struct NodeOps<false> {
  static constexpr int kPer = 1;  // nodes an element
  static __device__ __forceinline__ float from(float a, float) { return a; }
  static __device__ __forceinline__ float one() { return 1.0f; }
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
  static __device__ __forceinline__ float get(float e, int) { return e; }
};

template <>
struct NodeOps<true> {
  using E = __nv_bfloat162;
  static constexpr int kPer = 2;
  static __device__ __forceinline__ E from(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ E one() { return __float2bfloat162_rn(1.0f); }
  static __device__ __forceinline__ E mul(E a, E b) { return __hmul2_rn(a, b); }
  static __device__ __forceinline__ E add(E a, E b) { return __hadd2_rn(a, b); }
  static __device__ __forceinline__ E sub(E a, E b) { return __hadd2_rn(a, __hneg2(b)); }
  static __device__ __forceinline__ float get(E e, int j) {
    return j ? __high2float(e) : __low2float(e);
  }
};

// r at N nodes from one degree-l A/B table row (the stage-1 probe): the
// arithmetic of sh_device.cuh radius_power_ab<kBf16> node for node, at
// degree L (L = -1: l), so each coefficient load feeds N nodes. f32: the
// unit-scale row, scaled by s at the end. bf16: a row pre-scaled and
// rounded to bf16, each value in both halves of a pair; ct, st, cp, sp are
// rounded to bf16 and every op of the chains, of the cos/sin(m phi) and
// sin^m recurrences and of the m-sum runs on node pairs (s unused).
template <int L, bool kBf16, int N>
__device__ __forceinline__ void radius_ab_nodes(const Coef<kBf16>* t, float s, int l,
                                                const float (&ct)[N], const float (&st)[N],
                                                const float (&cp)[N], const float (&sp)[N],
                                                float (&r)[N]) {
  using Op = NodeOps<kBf16>;
  constexpr int K = Op::kPer, M = N / K;
  static_assert(N % K == 0, "bf16 runs the nodes in pairs");
  const int lm = L >= 0 ? L : l;
  Coef<kBf16> x[M], stv[M], cpv[M], spv[M], acc[M], cos_m[M], sin_m[M], st_m[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    x[i] = Op::from(ct[K * i], ct[K * i + K - 1]);
    stv[i] = Op::from(st[K * i], st[K * i + K - 1]);
    cpv[i] = Op::from(cp[K * i], cp[K * i + K - 1]);
    spv[i] = Op::from(sp[K * i], sp[K * i + K - 1]);
    acc[i] = t[0];
    cos_m[i] = cpv[i];
    sin_m[i] = spv[i];
    st_m[i] = Op::one();
  }
#pragma unroll
  for (int k = 1; k <= lm; ++k) {
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = Op::add(Op::mul(acc[i], x[i]), t[k]);
  }
  int oA = lm + 1, oB = a_width(lm);
#pragma unroll
  for (int m = 1; m <= lm; ++m) {
    // A_m and B_m (nab coefficients each), side by side.
    const int nab = lm - m + 1;
    Coef<kBf16> A[M], B[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      A[i] = t[oA];
      B[i] = t[oB];
    }
#pragma unroll
    for (int k = 1; k < nab; ++k) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        A[i] = Op::add(Op::mul(A[i], x[i]), t[oA + k]);
        B[i] = Op::add(Op::mul(B[i], x[i]), t[oB + k]);
      }
    }
    oA += nab;
    oB += nab;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (m > 1) {
        const Coef<kBf16> c = Op::sub(Op::mul(cos_m[i], cpv[i]), Op::mul(sin_m[i], spv[i]));
        sin_m[i] = Op::add(Op::mul(sin_m[i], cpv[i]), Op::mul(cos_m[i], spv[i]));
        cos_m[i] = c;
      }
      st_m[i] = Op::mul(st_m[i], stv[i]);
      acc[i] = Op::add(acc[i], Op::mul(st_m[i], Op::add(Op::mul(cos_m[i], A[i]),
                                                        Op::mul(sin_m[i], B[i]))));
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    r[j] = Op::get(acc[j / K], j % K);
    if constexpr (!kBf16) r[j] *= s;
  }
}

// The degrees compiled into the stage-2 and wall kernels: 0 (the two-body
// collision), 2 (the settling box, the small drums), 4 (the small drums;
// the reference's triaxial cell) and 8 (the drum, the deposition, the
// drift gas). Returns fn(std::integral_constant<int, L>()) at L = lmax
// where that degree is compiled, else at L = -1 (the degree read at run
// time).
template <class Fn>
int with_degree(int lmax, Fn&& fn) {
  switch (lmax) {
    case 0:
      return fn(std::integral_constant<int, 0>());
    case 2:
      return fn(std::integral_constant<int, 2>());
    case 4:
      return fn(std::integral_constant<int, 4>());
    case 8:
      return fn(std::integral_constant<int, 8>());
    default:
      return fn(std::integral_constant<int, -1>());
  }
}

// Node slots a lane's blocks of nb nodes span over G cap nodes (lanes
// stride by 32 nb): a kernel takes 3-node blocks where they span fewer
// slots than 2-node ones (288 nodes: 9 against 10), else 2 (128: 4).
inline int node_slots(int G, int nb) { return (G + 32 * nb - 1) / (32 * nb) * nb; }

}  // namespace shk
