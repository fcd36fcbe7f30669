// SAGAN attention out = softmax(theta . phi^T) . g for the non-local block,
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of compare_gan_tpu/ops/pallas_attention.py:
//   attention_fwd_kernel       <- _fwd_kernel (via _attention_fwd_pallas)
//   attention_bwd_rows_kernel  \
//   attention_bwd_cols_kernel  /  <- _bwd_kernel (via _attention_bwd_pallas)
//
// Shapes: theta [B,N,C], phi [B,M,C], g [B,M,Cg], all f32 or all bf16,
// row-major and contiguous. On the BigGAN-128 main path N = 4096, M = 1024,
// (C, Cg) = (24, 96) after G's block B4 and (12, 48) after D's block B1.
//
// What bounds it on this card. The [B,N,M] score work is
// N*M*(C + Cg) multiply-adds per example in the forward and about twice that
// in each backward pass, against only (N*C + M*(C+Cg) + N*Cg) elements read
// and written: a few hundred operations per byte, so the kernels are bound
// by arithmetic, not by device memory, as long as the [B,N,M] scores never
// leave the SM. C is 12 or 24, too shallow for a tensor-core MMA without
// padding, so this first version runs the products as f32 FMAs on the CUDA
// cores (wgmma with C padded to 16/32 is later work).
//
// Design. Every score, exponent and sum is f32, whatever the input type.
//  * A group of kLanes = 4 consecutive threads owns one row (forward and
//    backward row pass) or one column (backward column pass). Each lane keeps
//    the whole C-vector for the score dot product (C is small), and a quarter
//    of the Cg channels; dot products over Cg are summed across the four
//    lanes with two xor-shuffles, which give all four lanes the same bits.
//  * phi/g (or theta/dout) are staged through shared memory in tiles of
//    kTile keys (rows), converted to f32 and zero-padded to the compile-time
//    widths, so the inner loops are fully unrolled without bounds checks.
//  * Forward: online softmax over M in chunks of kChunk keys (one rescale of
//    the accumulator per chunk). It writes out = (sum_m e*g) / den in the
//    input type and the final row max mx and denominator den in f32, exactly
//    the statistics _fwd_kernel saves for the backward.
//  * Backward: the TPU kernel accumulates dphi and dg across row tiles in
//    grid order (pl.when(j == 0) zero-init); GPU blocks run in no order, so
//    the work is split into two launches and uses no atomics, which keeps
//    the gradients bitwise deterministic from run to run:
//      1. rows: attn = exp(s - mx) / den, dattn = dout . g^T,
//         row = sum_m dattn*attn (as _bwd_kernel:165; rowsum(dout*out) would
//         be wrong for a bf16 out), and
//         dtheta = sum_m attn*(dattn - row)*phi, accumulated in one pass as
//         sum_m attn*dattn*phi - row * sum_m attn*phi.
//         It writes dtheta in the input type and row as [B,N] f32 scratch.
//      2. columns: one group per key m loops over all N rows and accumulates
//         dphi = sum_n attn*(dattn - row)*theta and dg = sum_n attn*dout in
//         f32 registers; written once, in f32, as _bwd_kernel's outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kLanes = 4;            // threads sharing one row or column
constexpr int kGroups = 64;          // rows (or columns) per block
constexpr int kThreads = kLanes * kGroups;
constexpr int kTile = 64;            // keys (or rows) per shared-memory tile
constexpr int kChunk = 16;           // keys per online-softmax rescale

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Sum over the four lanes of a group; every lane gets the same bits.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Stage rows [r0, r0 + kTile) of a [rows, width] matrix into a f32 tile of
// kTile x CP, zero beyond `rows` and `width`.
template <typename T, int CP>
__device__ __forceinline__ void stage_full(float (*dst)[CP], const T* src,
                                           int r0, int rows, int width) {
  for (int idx = threadIdx.x; idx < kTile * CP; idx += kThreads) {
    const int r = idx / CP, c = idx % CP, row = r0 + r;
    dst[r][c] = (row < rows && c < width)
                    ? to_f32(src[static_cast<long>(row) * width + c])
                    : 0.f;
  }
}

// Same for the wide operand, stored as kLanes slices of GL channels with a
// slice stride of GL + 1 floats, so the four lanes of a group read from four
// different banks.
template <typename T, int GL>
__device__ __forceinline__ void stage_sliced(float (*dst)[kLanes * (GL + 1)],
                                             const T* src, int r0, int rows,
                                             int width) {
  for (int idx = threadIdx.x; idx < kTile * kLanes * GL; idx += kThreads) {
    const int r = idx / (kLanes * GL), c = idx % (kLanes * GL);
    const int row = r0 + r;
    dst[r][(c / GL) * (GL + 1) + c % GL] =
        (row < rows && c < width)
            ? to_f32(src[static_cast<long>(row) * width + c])
            : 0.f;
  }
}

template <typename T, int CP, int GL>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                     const T* __restrict__ g, T* __restrict__ out,
                     float* __restrict__ mx_out, float* __restrict__ den_out,
                     int N, int M, int C, int Cg) {
  constexpr int GLS = GL + 1;
  __shared__ float phi_s[kTile][CP];
  __shared__ float g_s[kTile][kLanes * GLS];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kGroups + threadIdx.x / kLanes;
  const bool row_ok = i < N;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg;

  float th[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c)
    th[c] = (row_ok && c < C)
                ? to_f32(theta[(static_cast<long>(b) * N + i) * C + c])
                : 0.f;
  float acc[GL];
#pragma unroll
  for (int k = 0; k < GL; ++k) acc[k] = 0.f;
  float mx = -INFINITY, den = 0.f;

  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();  // The previous tile is consumed.
    stage_full<T, CP>(phi_s, phi_b, j0, M, C);
    stage_sliced<T, GL>(g_s, g_b, j0, M, Cg);
    __syncthreads();
    const int nkeys = min(kTile, M - j0);
    for (int k0 = 0; k0 < nkeys; k0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < CP; ++c) v = fmaf(th[c], phi_s[k0 + jj][c], v);
        s[jj] = (k0 + jj < nkeys) ? v : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      // Key k0 is always valid, so new_mx is finite; exp(-inf) = 0 on the
      // first chunk, where acc and den are still 0.
      const float new_mx = fmaxf(mx, cmax);
      const float scale = expf(mx - new_mx);
      den *= scale;
#pragma unroll
      for (int k = 0; k < GL; ++k) acc[k] *= scale;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - new_mx);
        den += p;
        const float* gr = &g_s[k0 + jj][lane * GLS];
#pragma unroll
        for (int k = 0; k < GL; ++k) acc[k] = fmaf(p, gr[k], acc[k]);
      }
      mx = new_mx;
    }
  }

  if (row_ok) {
    const long base = (static_cast<long>(b) * N + i) * Cg + lane * GL;
#pragma unroll
    for (int k = 0; k < GL; ++k)
      if (lane * GL + k < Cg) store(out, base + k, acc[k] / den);
    if (lane == 0) {
      mx_out[static_cast<long>(b) * N + i] = mx;
      den_out[static_cast<long>(b) * N + i] = den;
    }
  }
}

template <typename T, int CP, int GL>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const T* __restrict__ theta,
                          const T* __restrict__ phi, const T* __restrict__ g,
                          const T* __restrict__ dout,
                          const float* __restrict__ mx,
                          const float* __restrict__ den,
                          T* __restrict__ dtheta, float* __restrict__ row_out,
                          int N, int M, int C, int Cg) {
  constexpr int GLS = GL + 1;
  constexpr int CL = CP / kLanes;
  __shared__ float phi_s[kTile][CP];
  __shared__ float g_s[kTile][kLanes * GLS];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kGroups + threadIdx.x / kLanes;
  const bool row_ok = i < N;
  const long bi = static_cast<long>(b) * N + i;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg;

  float th[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c)
    th[c] = (row_ok && c < C) ? to_f32(theta[bi * C + c]) : 0.f;
  float dor[GL];
#pragma unroll
  for (int k = 0; k < GL; ++k) {
    const int c = lane * GL + k;
    dor[k] = (row_ok && c < Cg) ? to_f32(dout[bi * Cg + c]) : 0.f;
  }
  const float m_i = row_ok ? mx[bi] : 0.f;
  const float den_i = row_ok ? den[bi] : 1.f;

  float a_acc[CL], b_acc[CL];
#pragma unroll
  for (int q = 0; q < CL; ++q) a_acc[q] = b_acc[q] = 0.f;
  float row = 0.f;

  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();
    stage_full<T, CP>(phi_s, phi_b, j0, M, C);
    stage_sliced<T, GL>(g_s, g_b, j0, M, Cg);
    __syncthreads();
    const int nkeys = min(kTile, M - j0);
#pragma unroll 2
    for (int j = 0; j < nkeys; ++j) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) s = fmaf(th[c], phi_s[j][c], s);
      const float attn = expf(s - m_i) / den_i;
      const float* gr = &g_s[j][lane * GLS];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < GL; ++k) part = fmaf(dor[k], gr[k], part);
      const float dattn = group_sum(part);
      const float t = attn * dattn;
      row += t;
      const float* pr = &phi_s[j][lane * CL];
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        a_acc[q] = fmaf(t, pr[q], a_acc[q]);
        b_acc[q] = fmaf(attn, pr[q], b_acc[q]);
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int q = 0; q < CL; ++q) {
      const int c = lane * CL + q;
      if (c < C) store(dtheta, bi * C + c, a_acc[q] - row * b_acc[q]);
    }
    if (lane == 0) row_out[bi] = row;
  }
}

template <typename T, int CP, int GL>
__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_kernel(const T* __restrict__ theta,
                          const T* __restrict__ phi, const T* __restrict__ g,
                          const T* __restrict__ dout,
                          const float* __restrict__ mx,
                          const float* __restrict__ den,
                          const float* __restrict__ row,
                          float* __restrict__ dphi, float* __restrict__ dg,
                          int N, int M, int C, int Cg) {
  constexpr int GLS = GL + 1;
  constexpr int CL = CP / kLanes;
  __shared__ float th_s[kTile][CP];
  __shared__ float do_s[kTile][kLanes * GLS];
  __shared__ float mx_s[kTile], den_s[kTile], row_s[kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int m = blockIdx.x * kGroups + threadIdx.x / kLanes;
  const bool col_ok = m < M;
  const long bm = static_cast<long>(b) * M + m;
  const T* theta_b = theta + static_cast<long>(b) * N * C;
  const T* dout_b = dout + static_cast<long>(b) * N * Cg;

  float ph[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c)
    ph[c] = (col_ok && c < C) ? to_f32(phi[bm * C + c]) : 0.f;
  float gg[GL];
#pragma unroll
  for (int k = 0; k < GL; ++k) {
    const int c = lane * GL + k;
    gg[k] = (col_ok && c < Cg) ? to_f32(g[bm * Cg + c]) : 0.f;
  }
  float dphi_acc[CL], dg_acc[GL];
#pragma unroll
  for (int q = 0; q < CL; ++q) dphi_acc[q] = 0.f;
#pragma unroll
  for (int k = 0; k < GL; ++k) dg_acc[k] = 0.f;

  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    stage_full<T, CP>(th_s, theta_b, i0, N, C);
    stage_sliced<T, GL>(do_s, dout_b, i0, N, Cg);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool ok = i0 + r < N;
      const long bi = static_cast<long>(b) * N + i0 + r;
      mx_s[r] = ok ? mx[bi] : 0.f;
      den_s[r] = ok ? den[bi] : 1.f;
      row_s[r] = ok ? row[bi] : 0.f;
    }
    __syncthreads();
    const int nrows = min(kTile, N - i0);
#pragma unroll 2
    for (int r = 0; r < nrows; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) s = fmaf(th_s[r][c], ph[c], s);
      const float attn = expf(s - mx_s[r]) / den_s[r];
      const float* dr = &do_s[r][lane * GLS];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < GL; ++k) part = fmaf(dr[k], gg[k], part);
      const float dattn = group_sum(part);
      const float ds = attn * (dattn - row_s[r]);
      const float* tr = &th_s[r][lane * CL];
#pragma unroll
      for (int q = 0; q < CL; ++q) dphi_acc[q] = fmaf(ds, tr[q], dphi_acc[q]);
#pragma unroll
      for (int k = 0; k < GL; ++k) dg_acc[k] = fmaf(attn, dr[k], dg_acc[k]);
    }
  }

  if (col_ok) {
#pragma unroll
    for (int q = 0; q < CL; ++q) {
      const int c = lane * CL + q;
      if (c < C) dphi[bm * C + c] = dphi_acc[q];
    }
#pragma unroll
    for (int k = 0; k < GL; ++k) {
      const int c = lane * GL + k;
      if (c < Cg) dg[bm * Cg + c] = dg_acc[k];
    }
  }
}

struct Args {
  const void *theta, *phi, *g, *dout;
  const float *mx_in, *den_in;
  void *out, *dtheta;
  float *mx, *den, *row, *dphi, *dg;
  int B, N, M, C, Cg;
  cudaStream_t stream;
};

template <typename T, int CP, int GL>
int launch_fwd(const Args& a) {
  dim3 grid((a.N + kGroups - 1) / kGroups, a.B);
  attention_fwd_kernel<T, CP, GL><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
      static_cast<const T*>(a.g), static_cast<T*>(a.out), a.mx, a.den, a.N,
      a.M, a.C, a.Cg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CP, int GL>
int launch_bwd(const Args& a) {
  dim3 grid_rows((a.N + kGroups - 1) / kGroups, a.B);
  attention_bwd_rows_kernel<T, CP, GL><<<grid_rows, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
      static_cast<const T*>(a.g), static_cast<const T*>(a.dout), a.mx_in,
      a.den_in, static_cast<T*>(a.dtheta), a.row, a.N, a.M, a.C, a.Cg);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dim3 grid_cols((a.M + kGroups - 1) / kGroups, a.B);
  attention_bwd_cols_kernel<T, CP, GL><<<grid_cols, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
      static_cast<const T*>(a.g), static_cast<const T*>(a.dout), a.mx_in,
      a.den_in, a.row, a.dphi, a.dg, a.N, a.M, a.C, a.Cg);
  return static_cast<int>(cudaGetLastError());
}

// Exact widths for the two main-path shapes, a zero-padded generic
// instantiation for any C <= 32, Cg <= 128.
template <typename T, bool kForward>
int dispatch(const Args& a) {
  if (a.C == 12 && a.Cg == 48)
    return kForward ? launch_fwd<T, 12, 12>(a) : launch_bwd<T, 12, 12>(a);
  if (a.C == 24 && a.Cg == 96)
    return kForward ? launch_fwd<T, 24, 24>(a) : launch_bwd<T, 24, 24>(a);
  if (a.C <= 32 && a.Cg <= 128)
    return kForward ? launch_fwd<T, 32, 32>(a) : launch_bwd<T, 32, 32>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int cgt_attention_fwd(const void* theta, const void* phi, const void* g,
                      void* out, void* mx, void* den, int B, int N, int M,
                      int C, int Cg, int is_bf16, void* stream) {
  Args a{};
  a.theta = theta;
  a.phi = phi;
  a.g = g;
  a.out = out;
  a.mx = static_cast<float*>(mx);
  a.den = static_cast<float*>(den);
  a.B = B;
  a.N = N;
  a.M = M;
  a.C = C;
  a.Cg = Cg;
  a.stream = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16, true>(a) : dispatch<float, true>(a);
}

// Two launches (rows, then columns) on one stream; returns the first
// non-zero cudaGetLastError().
int cgt_attention_bwd(const void* theta, const void* phi, const void* g,
                      const void* dout, const void* mx, const void* den,
                      void* dtheta, void* row, void* dphi, void* dg, int B,
                      int N, int M, int C, int Cg, int is_bf16,
                      void* stream) {
  Args a{};
  a.theta = theta;
  a.phi = phi;
  a.g = g;
  a.dout = dout;
  a.mx_in = static_cast<const float*>(mx);
  a.den_in = static_cast<const float*>(den);
  a.dtheta = dtheta;
  a.row = static_cast<float*>(row);
  a.dphi = static_cast<float*>(dphi);
  a.dg = static_cast<float*>(dg);
  a.B = B;
  a.N = N;
  a.M = M;
  a.C = C;
  a.Cg = Cg;
  a.stream = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16, false>(a)
                 : dispatch<float, false>(a);
}

const char* cgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
