// Posit softmax: per row, decode -> stable f32 softmax -> encode in the same
// format (the paper's section IV-C softmax benchmark).
//
// Replaces: src/repro/kernels/posit_softmax/posit_softmax.py,
// `posit_softmax_kernel` (Pallas body `_softmax_kernel`).
//
// Bound on the H100: device-memory bytes. Each code is read once and each
// output code written once; the f32 work per element (a compare, a subtract,
// an expf, an add, a divide) is far below the card's rate. What costs time
// at the path's shapes is how many SMs a row reaches and how often each code
// is decoded.
//
// Design: every element is decoded once, into registers, and its exp taken
// once (e = expf(x - max), kept for the divide). Two row shapes, planned by
// kernels/posit_softmax/ops.py `row_plan`:
// * Narrow rows (C <= 1024, the paper's 8 / 32 / 128): one warp per row,
//   eight rows a block; the max and the sum are warp shuffles.
// * Wide rows (a vocabulary): a thread-block cluster of up to 16 blocks per
//   row, each block owning a contiguous chunk. Each block reduces its chunk's
//   max, the cluster takes the max of those over distributed shared memory,
//   each block sums exp(x - max) over its chunk, and the cluster adds the
//   blocks' sums in rank order. One launch, no atomics, and a fixed order,
//   so the result is the same on every run. A chunk wider than the block's
//   registers (more than 32 values a thread) takes its tail from global
//   memory again in each pass.
// Columns beyond C do not exist here, so the TPU kernel's -inf padding
// becomes the loop bound. expf (not __expf) and the IEEE divide keep the
// result within one posit ulp of the plain version. A NaR code decodes to
// NaN, which fmaxf skips but the sum carries, so its row comes out all NaR.
#include <cmath>
#include <cooperative_groups.h>

#include "posit_codec.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kRowWarps = 8;      // narrow rows: rows (warps) a block
constexpr int kWideThreads = 512; // wide rows: threads of a cluster block

template <int NB>
__device__ __forceinline__ float load(const void* p, long long i, int es, const float* tab) {
  if constexpr (NB == 8) {
    return tab[static_cast<const uint8_t*>(p)[i]];
  } else {
    return posit::decode(static_cast<const uint16_t*>(p)[i], 16, es);
  }
}

template <int NB>
__device__ __forceinline__ void store(void* p, long long i, float y, int es) {
  const uint32_t code = posit::encode(y, NB, es);
  if constexpr (NB == 8) static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(code);
  else static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(code);
}

__device__ __forceinline__ float warp_reduce(float v, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  return v;
}

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  v = warp_reduce(v, is_max);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  __syncthreads();  // red[] may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_reduce(lane < n_warps ? red[lane] : (is_max ? -INFINITY : 0.0f), is_max);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Narrow rows: warp w of block b owns row b * kRowWarps + w; lane l holds
// columns l, l + 32, ... (VPL of them).
template <int NB, int VPL>
__global__ void __launch_bounds__(kRowWarps * 32)
softmax_rows_kernel(const void* __restrict__ codes, void* __restrict__ out, int R, int C, int es) {
  __shared__ float tab[NB == 8 ? 256 : 1];
  if constexpr (NB == 8) posit::fill_p8_table(tab, es, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= R) return;
  const long long base = static_cast<long long>(row) * C;
  float x[VPL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = j * 32 + lane;
    x[j] = c < C ? load<NB>(codes, base + c, es, tab) : 0.0f;
    if (c < C) m = fmaxf(m, x[j]);
  }
  m = warp_reduce(m, true);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (j * 32 + lane < C) {
      x[j] = expf(x[j] - m);
      s += x[j];
    }
  }
  s = warp_reduce(s, false);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = j * 32 + lane;
    if (c < C) store<NB>(out, base + c, x[j] / s, es);
  }
}

// Wide rows: the cluster along x spans a row; block rank r owns columns
// [r * chunk, min(C, (r + 1) * chunk)). Rows step by gridDim.y.
template <int NB, int VPT>
__global__ void __launch_bounds__(kWideThreads)
softmax_cluster_kernel(const void* __restrict__ codes, void* __restrict__ out, int R, int C,
                       int chunk, int es) {
  __shared__ float tab[NB == 8 ? 256 : 1];
  __shared__ float red[kWideThreads / 32];
  __shared__ float part[2];  // this block's max and sum, read by the whole cluster
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (NB == 8) posit::fill_p8_table(tab, es, threadIdx.x, blockDim.x);
  __syncthreads();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int c0 = rank * chunk, c1 = min(C, c0 + chunk);
  const int held = c0 + VPT * kWideThreads;  // first column past the registers
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const long long base = static_cast<long long>(row) * C;
    float x[VPT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = c0 + j * kWideThreads + threadIdx.x;
      x[j] = c < c1 ? load<NB>(codes, base + c, es, tab) : 0.0f;
      if (c < c1) m = fmaxf(m, x[j]);
    }
    for (int c = held + threadIdx.x; c < c1; c += kWideThreads)
      m = fmaxf(m, load<NB>(codes, base + c, es, tab));
    m = block_reduce(m, true, red);
    if (threadIdx.x == 0) part[0] = m;
    cluster.sync();
    float mx = -INFINITY;
    for (int r = 0; r < blocks; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&part[0], r));
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (c0 + j * kWideThreads + static_cast<int>(threadIdx.x) < c1) {
        x[j] = expf(x[j] - mx);
        s += x[j];
      }
    }
    for (int c = held + threadIdx.x; c < c1; c += kWideThreads)
      s += expf(load<NB>(codes, base + c, es, tab) - mx);
    s = block_reduce(s, false, red);
    if (threadIdx.x == 0) part[1] = s;
    cluster.sync();
    float sum = *cluster.map_shared_rank(&part[1], 0);
    for (int r = 1; r < blocks; ++r) sum += *cluster.map_shared_rank(&part[1], r);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = c0 + j * kWideThreads + threadIdx.x;
      if (c < c1) store<NB>(out, base + c, x[j] / sum, es);
    }
    for (int c = held + threadIdx.x; c < c1; c += kWideThreads)
      store<NB>(out, base + c, expf(load<NB>(codes, base + c, es, tab) - mx) / sum, es);
    cluster.sync();  // every block has read part[] before the next row rewrites it
  }
}

template <int NB, int VPL>
cudaError_t launch_rows(const void* codes, void* out, int R, int C, int es, cudaStream_t s) {
  const int grid = (R + kRowWarps - 1) / kRowWarps;
  softmax_rows_kernel<NB, VPL><<<grid, kRowWarps * 32, 0, s>>>(codes, out, R, C, es);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_narrow(const void* codes, void* out, int R, int C, int es, cudaStream_t s) {
  if (C <= 32) return launch_rows<NB, 1>(codes, out, R, C, es, s);
  if (C <= 128) return launch_rows<NB, 4>(codes, out, R, C, es, s);
  if (C <= 256) return launch_rows<NB, 8>(codes, out, R, C, es, s);
  return launch_rows<NB, 32>(codes, out, R, C, es, s);
}

template <int NB, int VPT>
cudaError_t launch_cluster(const void* codes, void* out, int R, int C, int cluster, int chunk,
                           int es, cudaStream_t s) {
  auto kern = softmax_cluster_kernel<NB, VPT>;
  if (cluster > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, R < 65535 ? R : 65535, 1);
  cfg.blockDim = dim3(kWideThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, codes, out, R, C, chunk, es);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int NB>
cudaError_t launch_wide(const void* codes, void* out, int R, int C, int cluster, int chunk,
                        int es, cudaStream_t s) {
  if (chunk <= 8 * kWideThreads)
    return launch_cluster<NB, 8>(codes, out, R, C, cluster, chunk, es, s);
  return launch_cluster<NB, 32>(codes, out, R, C, cluster, chunk, es, s);
}

}  // namespace

extern "C" {

// codes, out: (R, C) posit codes of nbits (8 or 16), contiguous. cluster 0:
// a warp per row (C <= 1024); otherwise `cluster` blocks (1..16) per row,
// each owning `chunk` columns (kernels/posit_softmax/ops.py `row_plan`).
int posit_softmax_launch(const void* codes, void* out, int R, int C, int nbits, int es,
                         int cluster, int chunk, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if ((nbits != 8 && nbits != 16) || cluster < 0 || cluster > 16 ||
      (cluster == 0 && C > 32 * 32) ||
      (cluster > 0 && (chunk < 1 || static_cast<long long>(cluster) * chunk < C)))
    return static_cast<int>(cudaErrorInvalidValue);
  es = es < 0 ? 0 : (es > 3 ? 3 : es);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cluster == 0) {
    e = nbits == 8 ? launch_narrow<8>(codes, out, R, C, es, s)
                   : launch_narrow<16>(codes, out, R, C, es, s);
  } else {
    e = nbits == 8 ? launch_wide<8>(codes, out, R, C, cluster, chunk, es, s)
                   : launch_wide<16>(codes, out, R, C, cluster, chunk, es, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
