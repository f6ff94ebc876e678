// The panel route's factor step: K5 above the single launch's rows
// (spd_inverse_xf.cu), in a source of its own so that nvcc builds it beside
// that one.
//
// Replaces, for the n that the TPU takes whole in
// ops/pallas_xf.py:_spd_inverse_kernel_k and one thread block cannot, the
// single launch of spd_inverse_xf.cu: ops/cuda_xf.py:spd_inverse_panels
// runs the reference's right-looking panel design
// (clrs_tpu/ops/linalg.py:124-204)
// on the augmented matrix T = [A | I], so that one pass gives W = L^-1
// (the identity half, solved along) and A^-1 = W^T W comes from one K4
// launch.  Per panel of b rows, this launch factors the b x b diagonal
// block of T, L_d L_d^T = T[0:b, 0:b], with chol_xf.cuh's Cholesky, and
// solves the slab Z = L_d^-1 T[0:b, b:] (the trailing columns of A, which
// give L's column block as Z^T, and the identity half); K4 then forms
// -Z_A^T Z from the negated copy Y = -Z_A this launch also writes (a
// multiply by a negated operand is the negated product, bit for bit), and
// K8 adds it to T's trailing block, the next panel's T.
//
// What bounds it: latency, as the single launch.  The dependent chain of
// a panel is b Cholesky columns (a dot product, the sqrt and the div)
// and b slab rows (a dot product and the div by a stored reciprocal);
// across panels it sums to n of each, as in the single launch, but a dot
// product here has b terms, not n, and the O(n^3) work leaves the chain
// for K4.  So the slab's columns spread over the card: a group of G =
// group_width(np2(b)) lanes per column holds the column's solved rows in
// registers (lane l row l), so that a column's solve needs no barrier and
// no memory round trip; every block factors the diagonal block itself
// (the same operations, so the same bits) rather than wait for one that
// does.  L_d and its reciprocals live in per-block scratch, the pivot
// sums in shared memory.  The panel width (ops/cuda_xf.py: SPD_PANEL) is
// at most kMaxPanel, so that a dot product is one term per lane.
#include <cuda_runtime.h>

#include <cstring>

#include "chol_xf.cuh"

namespace {

// The description ops/cuda_xf.py:_panel_plan packs: 16 int64.
struct PanelDesc {
  long long k, B, b, w, nA;          // limbs, batch, panel rows, slab columns, of them negated
  long long t_ls, t_bs, t_rs, t_cs;  // T: limb, batch, row, column strides
  long long z_ls, z_bs, z_rs;        // Z: limb, batch, row strides (columns dense)
  long long y_ls, y_bs, y_rs;        // Y = -Z[:, :nA], likewise
  long long ok_bs;                   // flags: batch stride (rows dense)
};

constexpr int kMaxPanel = 32;

template <int K>
__host__ __device__ inline size_t panel_scratch(int b) {
  return (size_t)K * ((size_t)b * b + b) + b;  // L_d, its reciprocals, a block's flags
}

template <int K>
__global__ void __launch_bounds__(clrs::kBlockThreads)
    spd_panel_xf_kernel(const double* __restrict__ t, double* __restrict__ z,
                        double* __restrict__ y, double* __restrict__ okf,
                        double* __restrict__ scratch, const PanelDesc d, int np2) {
  using namespace clrs;
  extern __shared__ double smem[];
  const int b = (int)d.b;
  const size_t bb = (size_t)b * b;
  const size_t bat = blockIdx.y;
  const double* T = t + bat * d.t_bs;
  double* L = scratch + (bat * gridDim.x + blockIdx.x) * panel_scratch<K>(b);
  double* Rcp = L + K * bb;
  // every block factors; the first of a matrix's blocks writes its flags
  double* ok = blockIdx.x == 0 ? okf + bat * d.ok_bs : Rcp + (size_t)K * b;
  block_cholesky_xf<K>(XfView{T, d.t_ls, d.t_rs, d.t_cs}, L, Rcp, smem, ok, b, np2);

  const int G = group_width(np2), lane = threadIdx.x % G;
  const long long col = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool active = col < d.w;
  const double* R = T + (b + col) * d.t_cs;  // limb 0 of T[0, b + col]
  double* Z = z + bat * d.z_bs + col;
  double* Y = y + bat * d.y_bs + col;
  double zl[K], c[K], x[K], s[K], dg[K], rc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) zl[q] = 0.0;  // Z[lane, col], zero until solved
  for (int i = 0; i < b; ++i) {
    group_dot<K>(
        b, np2, active,
        [&](int tt, double(&v)[K]) { load_xf<K>(L + (size_t)i * b + tt, bb, v); },
        [&](int, double(&v)[K]) {
#pragma unroll
          for (int q = 0; q < K; ++q) v[q] = zl[q];
        },
        c);
    if (active && lane == 0) {
#pragma unroll
      for (int q = 0; q < K; ++q) c[q] = -c[q];
      load_xf<K>(R + i * d.t_rs, d.t_ls, x);
      xf_add_c<K>(x, c, s);
      load_xf<K>(L + (size_t)i * b + i, bb, dg);
      load_xf<K>(Rcp + i, b, rc);
      xf_div_recip<K>(s, dg, rc, c);
      store_xf<K>(Z + i * d.z_rs, d.z_ls, c);
      if (col < d.nA) {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = -c[q];
        store_xf<K>(Y + i * d.y_rs, d.y_ls, x);
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) c[q] = __shfl_sync(0xffffffffu, c[q], 0, G);
    if (lane == i) {
#pragma unroll
      for (int q = 0; q < K; ++q) zl[q] = c[q];
    }
  }
}

template <int K>
int launch_panel(const PanelDesc& d, const double* t, double* z, double* y, double* okf,
                 double* scratch, cudaStream_t stream) {
  if (d.B <= 0 || d.b <= 0) return 0;
  const int b = (int)d.b;
  if (b > kMaxPanel || d.B > 65535) return (int)cudaErrorInvalidValue;
  const int np2 = clrs::pow2_at_least(b);
  const long long per_block = clrs::kBlockThreads / clrs::group_width(np2);
  const dim3 grid((unsigned)((d.w + per_block - 1) / per_block), (unsigned)d.B);
  if (grid.x == 0) return 0;
  spd_panel_xf_kernel<K><<<grid, clrs::kBlockThreads, clrs::shared_bytes<K>(b), stream>>>(
      t, z, y, okf, scratch, d, np2);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: the 16 int64 of PanelDesc; t: T at desc's strides, its panel's
// diagonal block at the origin; z, y, okf: written at desc's strides;
// scratch: B * ceil(w / (256 / group_width(np2(b)))) * panel_scratch(b)
// float64 (ops/cuda_xf.py:_panel_plan).  Returns -1 for a limb count the
// library was not built for.
extern "C" int clrs_spd_panel_xf(const char* desc, const double* t, double* z, double* y,
                                 double* okf, double* scratch, void* stream) {
  PanelDesc d;
  std::memcpy(&d, desc, sizeof d);
  switch (d.k) {
#define CLRS_CASE(K)                                                              \
  case K:                                                                         \
    return launch_panel<K>(d, t, z, y, okf, scratch, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
