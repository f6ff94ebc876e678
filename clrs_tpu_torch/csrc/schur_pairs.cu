// K2: the Schur-complement block of one group of clusters at K limbs, the
// whole block in one launch, the pairings read where they lie.
//
// Replaces ops/pallas_xf.py:_schur_pairs_kernel_k (wrappers
// _schur_pairs_batched, _schur_pairs_batched_tiled, xf_schur_pairs_pallas)
// and the gather that feeds it (clrs_tpu/core/kernels.py:
// _schur_block_contribution_pallas): for the pairings PX, PY (G, m, T, m, T)
// and the weights HH (G, T, T), every output entry (g, i1, t1, i2, t2) of
// the rows t1 asked for (all T, or a band of T1 of them: the caller's views
// of PX's rows t1, PY's columns t1 and HH's rows t1), with
// (r1, s1) and (r2, s2) the pairs i1 and i2 of core/blockinfo.py:pair_list
// (s <= r, pair i = r (r + 1) / 2 + s), is
//     w = ((a0 b0 + a1 b1) + (a2 b2 + a3 b3)) HH[g, t1, t2],
//     a_i = PX[g, (s1, r1, s1, r1)_i, t1, (r2, r2, s2, s2)_i, t2],
//     b_i = PY[g, (s2, s2, r2, r2)_i, t2, (r1, s1, r1, s1)_i, t1],
// in K-limb arithmetic (eft.cuh: the dd sequences at K=2, the per-order
// cascades above), in the association of pallas_xf.py:613, every exact
// product at k <= 4 by the fused multiply-add (eft.cuh: two_prod_fma,
// Dekker's bits on its range), above by Dekker's splitting.  The output is
// (G, P, T, P, T) dense, P = m (m + 1) / 2: the (P K, P K) block layout
// with the rank slots still in place, which the caller segment-sums with
// xfloat.xf_sum (core/kernels.py).  The plain PyTorch version is
// clrs_tpu_torch/ops/cuda_xf.py:schur_pairs_torch, Dekker's throughout.
//
// What bounds it: memory at k=2, FP64 instructions from k=3 on (wide,
// m=3, T=128: PX, PY and HH are 19 T^2 K-limb values against 36 T^2 out).
// The pairings come as compute_pairings returns them, transposed views
// with t2 at unit stride and t1 at stride m^2 T, and every operand is read
// at its own strides (a description of the call, ops/cuda_xf.py:
// _schur_plan), so nothing is gathered or copied: the PY index that runs
// with t2 is the slow one, and a warp reading b along t2 would touch a
// 32-byte sector per lane.  The design:
// - a block per (g, pair i1, tile of ty <= 8 rows t1 by 32 columns t2),
//   a thread per (t1, t2), the lanes of a warp on neighbouring t2, so that
//   the loads of a and HH and the stores of w are coalesced;
// - the block first stages every PY slice its rows need, PY[g, br, t2,
//   bc, t1] for every br and bc in {r1, s1}, through shared memory: the
//   staging threads walk each slice along t1, its unit stride (8 t1 of a
//   row, 64 bytes, whole sectors), and the compute threads read it back
//   along t2; rows of 34 doubles keep both sides free of bank conflicts;
// - each thread then loops over the P pairs i2 of its row pair, reading
//   the 2m PX slices of its row pair, which stay in L1 across the loop,
//   and its staged b's, and writes its P outputs; HH is loaded once;
// - the exact products by the fused multiply-add at k <= 4: 2
//   instructions instead of Dekker's 17, which took a k=2 wide block from
//   14.1 to 11.8 us and a k=3 one from 29.7 to 23.5 on an H100 (PERF.md).
// The tile's rows halve while the staged slices (2 m K ty rows) exceed
// 100 KB, so that two blocks fit on an SM; the wrapper refuses an m that
// one row cannot stage.
#include <cuda_runtime.h>

#include <cstring>

#include "eft.cuh"

namespace {

constexpr int kTileT2 = 32;  // columns t2 of a tile: a warp's lanes
constexpr int kRow = kTileT2 + 2;  // doubles per staged row
constexpr int kMaxTileT1 = 8;
constexpr size_t kMaxShared = 232448;  // an H100 block's dynamic shared memory

// The exact products by the fused multiply-add where that measured faster
// on the H100 (PERF.md): k = 2, 3, 4.
template <int K>
constexpr bool kFma = K <= 4;

// The description ops/cuda_xf.py:_schur_plan packs: 23 int64.  T1 is the
// rows t1 of the output (the pairings' band of them, T at one rank), T its
// columns t2.
struct Desc {
  long long k, G, m, T, T1, P, ty;
  long long px[6];  // strides: limb, batch, row pair r, t1, column s, t2
  long long py[6];
  long long hh[4];  // strides: limb, batch, t1, t2
};

__host__ __device__ inline size_t shared_bytes(const Desc& d) {
  return sizeof(double) * 2 * (size_t)d.m * d.k * d.ty * kRow;
}

template <int K>
__global__ void __launch_bounds__(kTileT2 * kMaxTileT1)
    schur_pairs_kernel(const double* __restrict__ px, const double* __restrict__ py,
                       const double* __restrict__ hh, double* __restrict__ out,
                       const Desc d) {
  using namespace clrs;
  extern __shared__ double sb[];
  const int T = (int)d.T, T1 = (int)d.T1, m = (int)d.m, P = (int)d.P, ty = (int)d.ty;
  const int tiles2 = (T + kTileT2 - 1) / kTileT2, tiles1 = (T1 + ty - 1) / ty;
  long long blk = blockIdx.x;
  const int tile2 = (int)(blk % tiles2);
  blk /= tiles2;
  const int tile1 = (int)(blk % tiles1);
  blk /= tiles1;
  const int i1 = (int)(blk % P);
  const long long g = blk / P;
  int r1 = 0;
  while ((r1 + 1) * (r1 + 2) / 2 <= i1) ++r1;
  const int s1 = i1 - r1 * (r1 + 1) / 2;
  const int nc = r1 == s1 ? 1 : 2;  // the distinct PY columns r1, s1: slots 0, nc - 1
  const int t1_0 = tile1 * ty, t2_0 = tile2 * kTileT2;
  const size_t limb_rows = (size_t)ty * kRow;  // a staged limb: ty rows

  // stage b: slice (c, br) holds PY[g, br, t2, c ? s1 : r1, t1], limb q of
  // (t1, t2) at sb[((c m + br) K + q) ty kRow + (t1 - t1_0) kRow + t2 - t2_0];
  // the block's 32 ty threads take the tile's cells along t1 here
  const int st2 = threadIdx.x / ty, st1 = threadIdx.x % ty;
  if (t1_0 + st1 < T1 && t2_0 + st2 < T) {
    const double* src = py + g * d.py[1] + (t2_0 + st2) * d.py[3] + (t1_0 + st1) * d.py[5];
    double* dst = sb + st1 * kRow + st2;
    for (int c = 0; c < nc; ++c) {
      for (int br = 0; br < m; ++br) {
        const double* from = src + br * d.py[2] + (c ? s1 : r1) * d.py[4];
        double* to = dst + (size_t)(c * m + br) * K * limb_rows;
#pragma unroll
        for (int q = 0; q < K; ++q) to[q * limb_rows] = from[q * d.py[0]];
      }
    }
  }
  __syncthreads();

  const int lt2 = threadIdx.x % kTileT2, lt1 = threadIdx.x / kTileT2;
  const int t1 = t1_0 + lt1, t2 = t2_0 + lt2;
  if (t1 >= T1 || t2 >= T) return;
  double h[K];
  load_xf<K>(hh + g * d.hh[1] + t1 * d.hh[2] + t2 * d.hh[3], (size_t)d.hh[0], h);
  const double* pxg = px + g * d.px[1] + t1 * d.px[3] + t2 * d.px[5];
  const double* sbt = sb + lt1 * kRow + lt2;
  auto a_at = [&](int r, int s, double(&x)[K]) {
    load_xf<K>(pxg + r * d.px[2] + s * d.px[4], (size_t)d.px[0], x);
  };
  auto b_at = [&](int br, int c, double(&y)[K]) {
    load_xf<K>(sbt + (size_t)(c * m + br) * K * limb_rows, limb_rows, y);
  };
  const size_t n_out = (size_t)d.G * P * T1 * P * T;  // the output's limb stride
  double* o = out + (((size_t)g * P + i1) * T1 + t1) * P * T + t2;
  const int cs = nc - 1;
  int r2 = 0, s2 = 0;
  for (int i2 = 0; i2 < P; ++i2) {
    double x[K], y[K], p[K], q[K], s12[K], s34[K];
    a_at(s1, r2, x);
    b_at(s2, 0, y);
    xf_mul<K, kFma<K>>(x, y, p);
    a_at(r1, r2, x);
    b_at(s2, cs, y);
    xf_mul<K, kFma<K>>(x, y, q);
    xf_add<K>(p, q, s12);
    a_at(s1, s2, x);
    b_at(r2, 0, y);
    xf_mul<K, kFma<K>>(x, y, p);
    a_at(r1, s2, x);
    b_at(r2, cs, y);
    xf_mul<K, kFma<K>>(x, y, q);
    xf_add<K>(p, q, s34);
    xf_add<K>(s12, s34, p);
    xf_mul<K, kFma<K>>(p, h, q);
    store_xf<K>(o + (size_t)i2 * T, n_out, q);
    if (++s2 > r2) {
      ++r2;
      s2 = 0;
    }
  }
}

template <int K>
int launch(const Desc& d, const double* px, const double* py, const double* hh,
           double* out, cudaStream_t stream) {
  if (d.G <= 0 || d.T <= 0 || d.T1 <= 0) return 0;
  if (d.m < 1 || d.P != d.m * (d.m + 1) / 2 || d.ty < 1 || d.ty > kMaxTileT1)
    return (int)cudaErrorInvalidValue;
  const size_t shared = shared_bytes(d);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        schur_pairs_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks =
      d.G * d.P * ((d.T1 + d.ty - 1) / d.ty) * ((d.T + kTileT2 - 1) / kTileT2);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  schur_pairs_kernel<K><<<(unsigned)blocks, kTileT2 * (int)d.ty, shared, stream>>>(
      px, py, hh, out, d);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: the 23 int64 of Desc; px, py, hh: read at desc's strides; out:
// (k, G, P, T1, P, T) dense.  Returns -1 for a limb count the library was
// not built for, else a cudaError_t.
extern "C" int clrs_schur_pairs(const char* desc, const double* px, const double* py,
                                const double* hh, double* out, void* stream) {
  Desc d;
  std::memcpy(&d, desc, sizeof d);
  switch (d.k) {
#define CLRS_CASE(K)                                                        \
  case K:                                                                   \
    return launch<K>(d, px, py, hh, out, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
