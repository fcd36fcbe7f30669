// SAGAN attention out = softmax(theta . phi^T) . g for the non-local block,
// forward and backward, hand-written for Hopper (sm_90a) on the tensor cores.
//
// Replaces the TPU kernels of compare_gan_tpu/ops/pallas_attention.py:
//   attention_fwd_kernel       <- _fwd_kernel (via _attention_fwd_pallas)
//   attention_bwd_rows_kernel  \
//   attention_bwd_cols_kernel  /  <- _bwd_kernel (via _attention_bwd_pallas)
//
// Shapes: theta [B,N,C], phi [B,M,C], g [B,M,Cg], all f32 or all bf16,
// row-major and contiguous, any C and Cg. The non-local block gives
// (C, Cg) = (channels / 8, channels / 2) at N = 4096, M = 1024 on the
// 64x64 map: (24, 96) after BigGAN-128's G block B4 and (12, 48) after D's
// B1; (32, 128) in BigGAN-deep-128; (48, 192) after BigGAN-512's G block
// B4; (64, 256) in BigGAN-deep-256 and -512. With the attention on the
// 8x8 maps (the SAGAN paper's "feat8" placement), BigGAN-128 gives
// (192, 768) after G's B1 and (96, 384) after D's B4 at N = 64, M = 16.
//
// What bounds it on this card. The [B,N,M] score work is 2*N*M*(C + Cg)
// flops per example in the forward and 2*N*M*(3C + 2Cg) in the backward,
// against only (N*C + M*(C+Cg) + N*Cg) elements read and written: hundreds
// of operations per byte, so the work is bound by arithmetic as long as the
// scores never leave the SM. Two floors: the tensor cores (989 TFLOP/s bf16
// dense) and the special-function units, which take B*N*M exponentials per
// pass. C = 12 or 24 is shallow, so the score product is cheap next to the
// exponentials; Cg = 48 or 96 makes the P.g product the larger matmul.
// Measured on an H100 (tools/attention_variants.py, PERF.md), neither floor
// is what holds the forward back; the staging of its key tiles weighs most
// (every block re-reads its batch element's whole phi and g from L2 into
// shared memory by cp.async). For the backward at C <= 64 see the note
// above attention_bwd_rows_kernel.
//
// Design (FlashAttention-2/3 on wgmma; mma.sync past C 64):
//  * Every product runs on the tensor cores with bf16 operands and f32
//    accumulation. C is zero-padded to CP = 16, 32, 48 or 64 (multiples of
//    the MMA depth); a C > 64 is cut into chunks of 64, the last padded to
//    16, by the wide kernels (see there). A block covers 128 rows (128 keys
//    in the backward column pass), so each staged tile serves 128 rows: 8
//    warps in the forward and the wide kernels, and in the backward at C <=
//    64 two consumer warpgroups and a producer warp.
//  * Cg is cut into nz = ceil(Cg / 128) column chunks of equal width, each
//    zero-padded to GP = 48, 96 or 128, one chunk per blockIdx.z: a warp's
//    accumulators and operand fragments of width Cg would outgrow the 255
//    registers of a thread at Cg = 192 or 256 (the forward's O alone is 64
//    x GP f32 a warpgroup, the column pass's dg 16 x GP a warp). A chunk's
//    block recomputes the scores and their exponentials: C / Cg of the
//    P.g product and one more exponential pass per extra chunk. The
//    forward's chunks write disjoint columns of out (chunk 0 writes mx and
//    den). The backward is linear in (dout, g) column chunks given the
//    whole row term: chunk z's row pass takes dP_z = dout_z.g_z^T and
//    writes row_z = sum_m P*dP_z and dtheta_z = (P*dP_z).phi - row_z*(P.phi)
//    as f32 parts, which a third kernel sums in a fixed order (row first,
//    which the column pass reads); chunk z's column pass writes its own
//    columns of dg = P^T.dout_z and a part of dphi from
//    dS_z^T = P^T*(dP_z^T - [z = 0] row), summed likewise. With one chunk
//    the passes write their outputs directly, as before.
//  * The staged tiles live in dynamic shared memory (64 KB at most a block
//    in the forward and the wide kernels, 192 KB in the backward at C <= 64,
//    past the 48 KB of static shared memory).
//  * The kernels are compiled once per padded C (CGT_CP, one object each)
//    and once for C > 64 (CGT_WIDE), the objects built in parallel; the
//    entry object dispatches on C and Cg.
//  * Forward: wgmma m64nNk16 per warpgroup of 4 warps (64 rows), A from
//    registers, B from shared memory: S = theta.phi^T with N = 64 keys,
//    then O += P.g with N = GP, the g tile read transposed. The key tiles
//    are staged in wgmma's core-matrix layout (8 rows x 16 bytes a block).
//  * Backward at C <= 64: wgmma for every product of both passes, A and B
//    from shared memory for the score products, fed by TMA or cp.async
//    from a producer warp through a ring of 4 (bf16) or 2 (f32) stages
//    with an mbarrier each (the note above attention_bwd_rows_kernel).
//    Past C 64: mma.sync m16n8k16, whose 16-row fragments also fit the
//    column pass's transposed products (dS^T.theta, P^T.dout); B fragments
//    come from row-padded tiles (8 extra elements a row, free of bank
//    conflicts) by ldmatrix, transposed for P.g-like products.
//  * The forward's and the wide kernels' key (or row) tiles of 64 are
//    staged by cp.async into a two-buffer ring in shared memory, so the
//    next tile's copy is in flight while the current one is consumed; rows
//    beyond the edge are zero-filled by the copy itself.
//  * Scores never leave the registers: the f32 accumulator fragment of
//    S = theta.phi^T is exactly the A-operand layout of the next product
//    (for wgmma as for mma.sync), so P (or dS) is rounded in registers and
//    fed straight into O += P.g.
//  * Exponentials are ex2.approx on scores pre-scaled by log2(e).
//  * Forward: online softmax per 64-key tile, skipping the rescale of the
//    accumulators once a warp's row maxima stop changing. It writes
//    out = O/den in the input type and the row max mx and denominator den
//    in f32, the statistics _fwd_kernel saves for the backward.
//  * Backward, no atomics, so the gradients are bitwise deterministic run
//    to run (bitwise resume needs this). The TPU kernel accumulates dphi
//    and dg across row tiles in grid order; GPU blocks run in no order, so
//    it is two launches:
//      1. rows: recompute S and P = exp(S - mx)/den, dP = dout.g^T,
//         row = sum_m P*dP (as _bwd_kernel:165; rowsum(dout*out) would be
//         wrong for a bf16 out), and dtheta = (P*dP).phi - row*(P.phi),
//         both products accumulated on the tensor cores in one sweep.
//         It writes dtheta in the input type and row as [B,N] f32 scratch.
//      2. columns: a warpgroup owns 64 keys and loops over all N rows:
//         S^T = phi.theta^T, dP^T = g.dout^T, dS^T = P^T*(dP^T - row),
//         dphi += dS^T.theta and dg += P^T.dout in f32 registers, written
//         once in f32 as _bwd_kernel's outputs.
//  * Rounding: bf16 inputs make every MMA product exact in f32; the only
//    rounding beyond the f32 sums is that of P to bf16 before O += P.g in
//    the forward and of P to bf16 before dg += P^T.dout in the backward at
//    C <= 64. The backward keeps P (but for dg there), P*dP and dS as bf16
//    hi + lo parts (two MMAs per product, about 2^-17 relative): its sums
//    cancel where the attention is peaked (dtheta is the difference of two
//    products; dphi sums terms of either sign over all rows), and one bf16
//    rounding per term there exceeds the 2e-2 tolerance. f32 inputs are
//    split into bf16 hi + lo parts and each product takes four MMAs
//    (lo.lo + lo.hi + hi.lo + hi.hi; what the split drops is about 2^-17
//    relative per operand), so the f32 path keeps the 1e-4 agreement on
//    the tensor cores with the same fragment layouts; it stages its tiles
//    with plain loads (the split happens on the way into shared memory),
//    and its backward keeps P's lo part for dg as well.

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace cgt {

constexpr int kMaxChunk = 128;  // widest Cg chunk (GP)

struct Args {
  const void *theta, *phi, *g, *dout;
  const float *mx_in, *den_in;
  void *out, *dtheta;
  float *mx, *den, *row, *dphi, *dg;
  // The backward's f32 parts when Cg takes more than one chunk: dtheta
  // [nz, B, N, C] and dphi [nz, B, M, C]; `row` is then [nz, B, N] and its
  // part 0 the sum.
  float *dtheta_parts, *dphi_parts;
  int B, N, M, C, Cg, chunk;
  bool bf16;
  cudaStream_t stream;
  int nz() const { return (Cg + chunk - 1) / chunk; }
};

enum Kind { kFwd = 0, kRowsPass = 1, kColsPass = 2 };

// Launches `kind` for inputs of type T at C padded to CP (defined in the
// object compiled with CGT_CP = CP); returns cudaGetLastError().
template <typename T, int CP>
int launch_cp(const Args& a, int kind);

// The same at C > 64, in chunks of 64 (the object compiled with CGT_WIDE).
template <typename T>
int launch_wide(const Args& a, int kind);

}  // namespace cgt

#if defined(CGT_CP) || defined(CGT_WIDE)

// Dynamic shared memory, carved into each kernel's tiles; 16-byte aligned
// at least, as cp.async, ldmatrix and wgmma's descriptors need.
extern __shared__ __align__(128) unsigned char smem[];

namespace {

using cgt::Args;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows (column pass: keys) per block
constexpr int kTile = 64;           // keys (column pass: rows) per staged tile
constexpr float kLog2e = 1.4426950408889634f;

// Forward blocks each SM must hold, which caps the registers at 65536 /
// (256 * 2) = 128 a thread: on an H100, 16 warps an SM at 128 registers ran
// faster than the compiler's own choice of up to 255 registers (12 warps or
// fewer). At C > 32 it keeps the compiler's choice, since at 128 registers
// it spills.
constexpr int min_blocks(int CP) { return CP > 32 ? 1 : 2; }

template <typename T>
struct Traits {
  static constexpr bool kSplit = false;  // bf16 inputs: used as they are
};
template <>
struct Traits<float> {
  static constexpr bool kSplit = true;  // f32: hi/lo split, four MMAs
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Operand fragments of mma.m16n8k16: bf16 pairs, `h` the value (or its hi
// part), `l` the lo part (f32 inputs only).
struct FragA {
  uint32_t h[4], l[4];
};
struct FragB {
  uint32_t h[2], l[2];
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b, where an operand with kSplit* is the sum of its hi and lo
// parts: the small terms go first.
template <bool kSplitA, bool kSplitB = kSplitA>
__device__ __forceinline__ void mma(float* c, const FragA& a,
                                    const FragB& b) {
  if (kSplitA && kSplitB) mma_bf16(c, a.l, b.l);
  if (kSplitA) mma_bf16(c, a.l, b.h);
  if (kSplitB) mma_bf16(c, a.h, b.l);
  mma_bf16(c, a.h, b.h);
}

// (x, y) -> one bf16 pair (x in the low half), and with kSplit the pair of
// remainders.
template <bool kSplit>
__device__ __forceinline__ void pack(float x, float y, uint32_t& h,
                                     uint32_t& l) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  h = bits(v);
  if (kSplit)
    l = bits(__floats2bfloat162_rn(x - __low2float(v), y - __high2float(v)));
}

// The A fragment of a 16x16 block from two f32 accumulator fragments of
// 16x8 (columns 0-7 in c0, 8-15 in c1): the accumulator layout of one
// product is the A layout of the next.
template <bool kSplit>
__device__ __forceinline__ void acc_to_a(const float* c0, const float* c1,
                                         FragA& a) {
  pack<kSplit>(c0[0], c0[1], a.h[0], a.l[0]);
  pack<kSplit>(c0[2], c0[3], a.h[1], a.l[1]);
  pack<kSplit>(c1[0], c1[1], a.h[2], a.l[2]);
  pack<kSplit>(c1[2], c1[3], a.h[3], a.l[3]);
}

// The A fragment of rows [r0, r0+16) x columns [k0, k0+16) of a row-major
// [rows, width] matrix of row stride ld in device memory, zero outside it.
template <typename T>
__device__ __forceinline__ void load_a(const T* src, int r0, int rows,
                                       int k0, int width, int ld,
                                       FragA& a) {
  constexpr bool kSplit = Traits<T>::kSplit;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto at = [&](int r, int c) {
    return (r < rows && c < width)
               ? to_f32(src[static_cast<long>(r) * ld + c])
               : 0.f;
  };
  const int ra = r0 + g, rb = ra + 8, ca = k0 + 2 * t, cb = ca + 8;
  pack<kSplit>(at(ra, ca), at(ra, ca + 1), a.h[0], a.l[0]);
  pack<kSplit>(at(rb, ca), at(rb, ca + 1), a.h[1], a.l[1]);
  pack<kSplit>(at(ra, cb), at(ra, cb + 1), a.h[2], a.l[2]);
  pack<kSplit>(at(rb, cb), at(rb, cb + 1), a.h[3], a.l[3]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// B fragments (k x n = 16 x 8) of the two n-tiles [n0, n0+8) and
// [n0+8, n0+16) of B[k][n] = tile[n0 + n][k0 + k]: a staged tile whose
// rows are the product's n index (keys for S = theta.phi^T), one ldmatrix
// for four 8x8 blocks.
template <bool kSplit, int S>
__device__ __forceinline__ void load_b_nk2(const bf16* hi, const bf16* lo,
                                           int n0, int k0, FragB& b0,
                                           FragB& b1) {
  const int lane = threadIdx.x & 31;
  const int off = (n0 + (lane & 7) + (lane >> 4) * 8) * S + k0 +
                  ((lane >> 3) & 1) * 8;
  ldmatrix_x4(smem_addr(hi + off), b0.h[0], b0.h[1], b1.h[0], b1.h[1]);
  if (kSplit)
    ldmatrix_x4(smem_addr(lo + off), b0.l[0], b0.l[1], b1.l[0], b1.l[1]);
}

// B fragments of the two n-tiles [n0, n0+8) and [n0+8, n0+16) of
// B[k][n] = tile[k0 + k][n]: a staged tile whose rows are the product's k
// index (keys for O += P.g), read transposed by ldmatrix.
template <bool kSplit, int S>
__device__ __forceinline__ void load_b_kn2(const bf16* hi, const bf16* lo,
                                           int k0, int n0, FragB& b0,
                                           FragB& b1) {
  const int lane = threadIdx.x & 31;
  const int off = (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 +
                  (lane >> 4) * 8;
  ldmatrix_x4_trans(smem_addr(hi + off), b0.h[0], b0.h[1], b1.h[0], b1.h[1]);
  if (kSplit)
    ldmatrix_x4_trans(smem_addr(lo + off), b0.l[0], b0.l[1], b1.l[0],
                      b1.l[1]);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;  // 0: zero-fill, nothing read
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else if (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage rows [r0, r0 + kTile) of a row-major [rows, width] matrix of row
// stride ld into a bf16 tile of row stride S, zero beyond `rows` (and, on
// the synchronous path, beyond `width` up to W). bf16 with vec > 0:
// cp.async of vec bytes, consecutive threads on consecutive chunks of the
// tile's contiguous rows (the padding columns were zeroed once; with
// kFill, into the first `fill` >= width columns, those past `width`
// zero-filled by the copy: the wide kernels' last C chunk, padded to 16 in
// a tile that held a full chunk before); otherwise plain loads, which
// also split f32 into hi and lo tiles. A chunk's row comes from a multiply
// by the reciprocal of the chunks per row, exact while idx < 2^32 /
// per_row, in place of a division by that run-time count (some twenty
// instructions) per chunk.
template <typename T, int W, int S, bool kFill = false>
__device__ __forceinline__ void stage(bf16* hi, bf16* lo, const T* src,
                                      int r0, int rows, int width, int ld,
                                      int vec, int fill = 0) {
  if (!Traits<T>::kSplit && vec > 0) {
    const int bytes = width * static_cast<int>(sizeof(T));
    const int per_row = (kFill ? fill : width) * static_cast<int>(sizeof(T))
                        / vec;
    const unsigned inv = 0xFFFFFFFFu / per_row + 1;  // idx / per_row, exact
    for (int idx = threadIdx.x; idx < kTile * per_row; idx += kThreads) {
      const int r = __umulhi(idx, inv), q = idx - r * per_row;
      const bool ok = r0 + r < rows && (!kFill || q * vec < bytes);
      const char* s = reinterpret_cast<const char*>(
                          src + static_cast<long>(ok ? r0 + r : 0) * ld) +
                      (kFill && !ok ? 0 : q * vec);
      char* d = reinterpret_cast<char*>(hi + r * S) + q * vec;
      if (vec == 16)
        cp_async<16>(d, s, ok);
      else if (vec == 8)
        cp_async<8>(d, s, ok);
      else
        cp_async<4>(d, s, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W, c = idx - r * W;
    const float v = (r0 + r < rows && c < width)
                        ? to_f32(src[static_cast<long>(r0 + r) * ld + c])
                        : 0.f;
    const bf16 h = __float2bfloat16(v);
    hi[r * S + c] = h;
    if (Traits<T>::kSplit)
      lo[r * S + c] = __float2bfloat16(v - __bfloat162float(h));
  }
}

// Stage kTile floats from src[r0...], zero beyond `rows`.
__device__ __forceinline__ void stage_scalars(float* dst, const float* src,
                                              int r0, int rows) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool ok = r0 + r < rows;
    cp_async<4>(dst + r, src + (ok ? r0 + r : 0), ok);
  }
}

__device__ __forceinline__ void zero(bf16* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = __float2bfloat16(0.f);
}

// wgmma (m64nNk16, f32 accumulate) with A from registers and B from shared
// memory, for the forward. A warpgroup (4 warps) computes 64 rows; warp w
// of it supplies and receives rows 16w..16w+15 in the same fragment layouts
// as mma.sync m16n8k16, so the score accumulator is again the A operand of
// the next product. B is read through a descriptor of a tile in the
// no-swizzle core-matrix layout: 8 rows x 16 bytes contiguous per block,
// `lbo` bytes between blocks along K, `sbo` along N. kTransB = 1 reads a
// tile whose N index is contiguous (g for O += P.g).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo,
                                               int sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n48(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n96(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 ||
                    N == 128,
                "wgmma width");
  if (N == 16) wgmma_n16<kTransB>(d, a, b, scale_d);
  if (N == 32) wgmma_n32<kTransB>(d, a, b, scale_d);
  if (N == 48) wgmma_n48<kTransB>(d, a, b, scale_d);
  if (N == 64) wgmma_n64<kTransB>(d, a, b, scale_d);
  if (N == 96) wgmma_n96<kTransB>(d, a, b, scale_d);
  if (N == 128) wgmma_n128<kTransB>(d, a, b, scale_d);
}

// d (+)= a.b, where an operand with kSplit* is the sum of its hi and lo
// parts, as in mma(): the small terms go first. scale_d = 0 overwrites d.
template <bool kSplitA, bool kSplitB, int N, int kTransB>
__device__ __forceinline__ void wgmma_acc(float* d, const FragA& a,
                                          uint64_t bh, uint64_t bl,
                                          int scale_d) {
  if (kSplitA && kSplitB) {
    wgmma_rs<N, kTransB>(d, a.l, bl, scale_d);
    scale_d = 1;
  }
  if (kSplitA) {
    wgmma_rs<N, kTransB>(d, a.l, bh, scale_d);
    scale_d = 1;
  }
  if (kSplitB) {
    wgmma_rs<N, kTransB>(d, a.h, bl, scale_d);
    scale_d = 1;
  }
  wgmma_rs<N, kTransB>(d, a.h, bh, scale_d);
}

// Stage rows [r0, r0 + kTile) of a row-major [rows, width] matrix of row
// stride ld into a bf16 tile in the core-matrix layout: byte b of row r at
// (r % 8) * 16 + (b % 16) + (r / 8) * kRowGroup + (b / 16) * kColGroup,
// zero beyond `rows` (and, on the synchronous path, beyond `width` up to
// W). As stage(), with cp.async of vec bytes where it can (with kFill,
// into `fill` columns).
template <typename T, int W, int kRowGroup, int kColGroup, bool kFill = false>
__device__ __forceinline__ void stage_cm(bf16* hi, bf16* lo, const T* src,
                                         int r0, int rows, int width, int ld,
                                         int vec, int fill = 0) {
  auto at = [](bf16* base, int r, int b) {
    return reinterpret_cast<char*>(base) + (r % 8) * 16 + (b % 16) +
           (r / 8) * kRowGroup + (b / 16) * kColGroup;
  };
  if (!Traits<T>::kSplit && vec > 0) {
    const int bytes = width * static_cast<int>(sizeof(T));
    const int per_row = (kFill ? fill : width) * static_cast<int>(sizeof(T))
                        / vec;
    const unsigned inv = 0xFFFFFFFFu / per_row + 1;  // idx / per_row, exact
    for (int idx = threadIdx.x; idx < kTile * per_row; idx += kThreads) {
      const int r = __umulhi(idx, inv), q = idx - r * per_row;
      const bool ok = r0 + r < rows && (!kFill || q * vec < bytes);
      const char* s = reinterpret_cast<const char*>(
                          src + static_cast<long>(ok ? r0 + r : 0) * ld) +
                      (kFill && !ok ? 0 : q * vec);
      char* d = at(hi, r, q * vec);
      if (vec == 16)
        cp_async<16>(d, s, ok);
      else if (vec == 8)
        cp_async<8>(d, s, ok);
      else
        cp_async<4>(d, s, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W, c = idx - r * W;
    const float v = (r0 + r < rows && c < width)
                        ? to_f32(src[static_cast<long>(r0 + r) * ld + c])
                        : 0.f;
    const bf16 h = __float2bfloat16(v);
    *reinterpret_cast<bf16*>(at(hi, r, 2 * c)) = h;
    if (Traits<T>::kSplit)
      *reinterpret_cast<bf16*>(at(lo, r, 2 * c)) =
          __float2bfloat16(v - __bfloat162float(h));
  }
}

// Shared-memory ring: two buffers for bf16 (cp.async overlap); one for f32,
// whose hi and lo parts take the room of the second.
template <typename T>
struct Ring {
  static constexpr bool kSplit = Traits<T>::kSplit;
  static constexpr int kBuf = kSplit ? 1 : 2;
  static constexpr int kParts = kSplit ? 2 : 1;
};

// Runs body(buf) once per tile j in [0, ntiles) after issue(j, buf) staged
// tile j into buffer `buf`. bf16: tile j + 1 is in flight during tile j.
template <typename T, typename Issue, typename Body>
__device__ __forceinline__ void pipeline(int ntiles, Issue issue, Body body) {
  if (Ring<T>::kBuf == 2) {
    issue(0, 0);
    cp_async_commit();
    for (int j = 0; j < ntiles; ++j) {
      if (j + 1 < ntiles) issue(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
      body(j, j & 1);
      __syncthreads();  // buffer j & 1 is refilled at iteration j + 1
    }
  } else {
    for (int j = 0; j < ntiles; ++j) {
      issue(j, 0);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      body(j, 0);
      __syncthreads();
    }
  }
}

// One key tile of the forward, from the scores s = theta.phi^T of keys
// [key0, key0 + kTile) (the warpgroup's wgmma accumulator): the online
// softmax update of the row maxima m and sums l (this thread's two rows),
// and O += P.g with the tile's g staged at gh (gl: its lo part).
template <bool kSplit, int GP>
__device__ __forceinline__ void fwd_tile(float (&s)[kTile / 8][4],
                                         float (&o)[GP / 8][4],
                                         float (&m)[2], float (&l)[2],
                                         const bf16* gh, const bf16* gl,
                                         int key0, int M) {
  constexpr int kGColGroup = kTile / 8 * 128;
  const int t = threadIdx.x & 3;
  if (key0 + kTile > M) {
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nt * 8 + 2 * t + (e & 1) >= M) s[nt][e] = -INFINITY;
  }
  // Key key0 is valid, so each row's new max is finite; on the first
  // tile ex2(-inf) = 0 rescales the (zero) accumulators.
  float alpha[2], nb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mt = m[i];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
      mt = fmaxf(mt, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    alpha[i] = ex2((m[i] - mt) * kLog2e);
    m[i] = mt;
    nb[i] = -mt * kLog2e;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ex2(fmaf(s[nt][e], kLog2e, nb[e >> 1]));
      rs[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
  // Once the row maxima settle, alpha is 1 for every row of the warp and
  // the rescale (an identity) is skipped.
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int nt = 0; nt < GP / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
  }
  // All of P's fragments first: a register read by a wgmma in flight
  // must not be rewritten before the wait.
  FragA pa[kTile / 16];
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    acc_to_a<kSplit>(s[2 * kk], s[2 * kk + 1], pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_acc<kSplit, kSplit, GP, 1>(
        &o[0][0], pa[kk], wgmma_desc(gh + kk * 128, 128, kGColGroup),
        wgmma_desc(gl + kk * 128, 128, kGColGroup), 1);
  wgmma_commit();
  wgmma_wait();
}

// The forward's epilogue: out = O / den in the input type for rows
// r0 + [0, 16) of this warp and columns [c0, c0 + cw) of out, and with
// `stats` the row max mx and denominator den.
template <typename T, int GP>
__device__ __forceinline__ void fwd_store(float (&o)[GP / 8][4],
                                         const float (&m)[2], float (&l)[2],
                                         T* out, float* mx_out,
                                         float* den_out, int b, int r0,
                                         int N, int Cg, int c0, int cw,
                                         bool stats) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    if (row >= N) continue;
    const long base = (static_cast<long>(b) * N + row) * Cg + c0;
#pragma unroll
    for (int nt = 0; nt < GP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < cw) store(out, base + c, o[nt][2 * i] / l[i]);
      if (c + 1 < cw) store(out, base + c + 1, o[nt][2 * i + 1] / l[i]);
    }
    if (t == 0 && stats) {
      mx_out[static_cast<long>(b) * N + row] = m[i];
      den_out[static_cast<long>(b) * N + row] = l[i];
    }
  }
}

template <typename T, int CP, int GP>
__global__ void
__launch_bounds__(kThreads, min_blocks(CP))
attention_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                     const T* __restrict__ g, T* __restrict__ out,
                     float* __restrict__ mx_out, float* __restrict__ den_out,
                     int N, int M, int C, int Cg, int chunk, int vec_c,
                     int vec_g) {
  using R = Ring<T>;
  constexpr bool kSplit = R::kSplit;
  // phi tiles are B of S = theta.phi^T with K = C contiguous; g tiles are
  // B of O += P.g with N = Cg contiguous. In both, 8-key blocks run along
  // the tile's rows.
  constexpr int kPhiRowGroup = CP / 8 * 128, kGColGroup = kTile / 8 * 128;
  constexpr int kPhiTile = kTile * CP, kGTile = kTile * GP;
  bf16* const phi_s = reinterpret_cast<bf16*>(smem);  // [kBuf][kParts]
  bf16* const g_s = phi_s + R::kBuf * R::kParts * kPhiTile;
  auto phi_at = [&](int buf, int part) {
    return phi_s + (buf * R::kParts + part) * kPhiTile;
  };
  auto g_at = [&](int buf, int part) {
    return g_s + (buf * R::kParts + part) * kGTile;
  };

  const int b = blockIdx.y, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows + warp * 16;
  // This block's columns [c0, c0 + cw) of g and out.
  const int c0 = blockIdx.z * chunk;
  const int cw = Cg - c0 < chunk ? Cg - c0 : chunk;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg + c0;

  if (!kSplit) {  // padding columns stay zero; cp.async writes the rest
    zero(phi_s, R::kBuf * R::kParts * (kPhiTile + kGTile));
    __syncthreads();
  }

  FragA th[CP / 16];
#pragma unroll
  for (int kc = 0; kc < CP / 16; ++kc)
    load_a(theta + static_cast<long>(b) * N * C, r0, N, kc * 16, C, C,
           th[kc]);

  float o[GP / 8][4];
#pragma unroll
  for (int nt = 0; nt < GP / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  auto issue = [&](int j, int buf) {
    stage_cm<T, CP, kPhiRowGroup, 128>(phi_at(buf, 0),
                                       phi_at(buf, R::kParts - 1), phi_b,
                                       j * kTile, M, C, C, vec_c);
    stage_cm<T, GP, 128, kGColGroup>(g_at(buf, 0), g_at(buf, R::kParts - 1),
                                     g_b, j * kTile, M, cw, Cg, vec_g);
  };
  auto body = [&](int j, int buf) {
    const bf16 *ph = phi_at(buf, 0), *phl = phi_at(buf, R::kParts - 1);
    float s[kTile / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc)
      wgmma_acc<kSplit, kSplit, kTile, 0>(
          &s[0][0], th[kc],
          wgmma_desc(ph + kc * 128, 128, kPhiRowGroup),
          wgmma_desc(phl + kc * 128, 128, kPhiRowGroup), kc > 0);
    wgmma_commit();
    wgmma_wait();
    fwd_tile<kSplit, GP>(s, o, m, l, g_at(buf, 0), g_at(buf, R::kParts - 1),
                         j * kTile, M);
  };
  pipeline<T>((M + kTile - 1) / kTile, issue, body);
  fwd_store<T, GP>(o, m, l, out, mx_out, den_out, b, r0, N, Cg, c0, cw,
                   blockIdx.z == 0);
}

// ---------------------------------------------------------------------------
// The backward at C <= 64 (CP = 16, 32, 48, 64; GP = 48, 96, 128), on wgmma
// fed by an asynchronous ring of tiles. Replaces PR 2's mma.sync passes.
//
// A block is kConsumers = 2 consumer warpgroups, each owning 64 rows (row
// pass) or 64 keys (column pass), and one producer warpgroup: 384 threads,
// one block an SM. setmaxnreg moves registers from the producer (64 a
// thread) to the consumers (216; the f32 column pass at GP 128 holds dg 64
// x 128 and dphi 64 x 64 in f32 besides the scores), where an even split
// would leave 168.
// Both passes keep the block-invariant operand of their two score products
// in shared memory as wgmma's A: theta and dout (row pass), phi and g
// (column pass), staged once by all threads, split into bf16 hi + lo parts
// for f32. The producer warpgroup stages the other operand tile by tile into a
// ring of kStages stages (4 for bf16, 2 for f32, whose hi and lo parts
// double a stage): phi and g (row pass), theta, dout and the per-row
// softmax terms (column pass: the exponent bias, which the row pass writes
// beside the row term, and the row term). Stage s is full when its
// mbarrier full[s] completes (an arrival from each producer thread and
// TMA's bytes) and free again when empty[s] does (one arrival from each
// consumer warp once its products on the stage have completed).
//
// Staging, by operand: bf16 with rows of a multiple of 8 elements and a
// 16-byte aligned base goes by TMA (cp.async.bulk.tensor, one box of 64
// rows x 8 columns per column group, rows past the end zero-filled by the
// copy, completion counted on full[s]); the tensor map is a 3-D view
// [B][rows][ld] encoded per launch. TMA cannot take rows whose stride is
// not a multiple of 16 bytes (D's C = 12, the ragged test shapes): those
// go by cp.async of 16, 8 or 4 bytes, zero-filled past the last row, and
// rows too odd for 4-byte copies (C = 7) and every f32 tile by plain loads
// in batches of four 16-byte rows a thread, which split f32 into hi and lo
// on the way into shared memory. A producer thread whose stage holds only
// copies arrives through cp.async.mbarrier.arrive.noinc, when its copies
// land, and goes on to the next stage at once; one that stored with plain
// loads waits for its copies, fences its stores to the async proxy and
// arrives. The consumers fence what they acquire to the async proxy
// before their products read it. So a stage's copies of every kind
// overlap the consumers' products on the stages before it.
//
// Tiles are in wgmma's no-swizzle core-matrix layout, column-group major:
// element (r, c) of a 64-row tile at byte (r % 8) * 16 + (r / 8) * 128 +
// (c % 8) * 2 + (c / 8) * kGroup (kGroup = 1024, one TMA box). One tile
// serves as a K-major operand (K = its columns: desc_k) and as an MN-major
// one (K = its rows: desc_mn), so the same phi tile feeds S = theta.phi^T
// and (P*dP).phi, the same theta tile S^T = phi.theta^T and dS^T.theta.
//
// Products, m64nNk16 per consumer warpgroup, f32 accumulate:
//   row pass: S = theta.phi^T and dP = dout.g^T (A and B from shared
//     memory, N = 64 keys), then a1 += (P*dP).phi and a2 += P.phi (A from
//     registers in the accumulator layout, B = the phi tile read MN-major,
//     N = CP); dtheta = a1 - row * a2, row = sum_m P*dP.
//   column pass: S^T = phi.theta^T and dP^T = g.dout^T (N = 64 rows), then
//     dphi += dS^T.theta (N = CP) and dg += P^T.dout (N = GP).
// Exponentials overlap products across the two consumer warpgroups: each
// waits only on its own wgmma groups and on the ring, so one's ex2s issue
// while the other's products are in flight.
//
// What bounds it, measured on an H100 (tools/attention_variants.py,
// PERF.md): at BigGAN-128's widths in bf16 the passes run at 20-40% of
// the rate of the MMAs they issue, and neither the staging, the
// exponentials, the hi/lo packing nor either group of products alone is
// what holds them: dropping any one of them saves 2-25% of a pass. What
// does is the dependent chain in each warpgroup (products, wait, the
// elementwise work and packing, products, wait), which two consumer
// warpgroups overlap only in part. Committing S and dP apart, so that the
// exponentials run while dP is in flight, was no faster (slower at G's
// widths), nor was deferring each tile's last wait past the next tile's
// score products.
//
// Hi + lo parts (two MMAs a product; four with f32 operands split): kept
// for P*dP and P in the row pass (dtheta is their difference, which
// cancels where the attention is peaked) and for dS in the column pass
// (dphi sums terms of either sign over all rows); P for dg takes its hi
// part alone with bf16 inputs (dg sums P*dout with P >= 0: no cancellation
// from P, so a bf16 rounding of each P stays far below the 2e-2 tolerance)
// and both parts with f32 inputs (1e-4).
//
// Grid: the row pass runs N/128 x B x nz blocks, the column pass M/128 x B
// x nz, one block an SM: 256 column blocks at B 32 fill two waves of 132 to
// 97%; B 38's 304 leave a third wave of 40 (the work comes in units of 128
// keys of one example; splitting N across blocks would need a sum of parts).
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;
static_assert(kRows == kConsumers * kTile, "a block's rows");
constexpr int kBwdThreads = 128 * (kConsumers + 1);
constexpr int kProducerWarp = 4 * kConsumers;  // the producer's first warp
constexpr int kProducers = 128;
// Registers a thread after setmaxnreg: 64 * 128 + 216 * 256 <= 65536.
constexpr int kProducerRegs = 64, kConsumerRegs = 216;
constexpr int kGroup = kTile * 16;  // bytes of one column group of a tile
constexpr int kTma = -1;            // a tile operand staged by TMA

template <typename T, int CP, int GP>
struct BwdSmem {
  static constexpr int kParts = Traits<T>::kSplit ? 2 : 1;
  static constexpr int kStages = Traits<T>::kSplit ? 2 : 4;
  static constexpr int kNTile = kTile * CP, kWTile = kTile * GP;  // elements
  // Block-invariant A operands: [kConsumers][kParts] narrow tiles, then
  // [kConsumers][kParts] wide tiles; then the ring's stages, each
  // [kParts] narrow tiles and [kParts] wide tiles.
  static constexpr int kInv = kConsumers * kParts * (kNTile + kWTile);
  static constexpr int kStage = kParts * (kNTile + kWTile);
  static constexpr int kTiles = kInv + kStages * kStage;  // bf16 elements
  // Then per stage the column pass's exponent bias and row term of 64 rows
  // (f32, zero past N and, but in column chunk 0, for the row term), and
  // the barriers full[kStages], empty[kStages].
  static constexpr int kScalars = kStages * 2 * kTile;
  static constexpr int kBytes = kTiles * 2 + kScalars * 4 + 2 * kStages * 8;

  bf16* base;
  __device__ explicit BwdSmem(unsigned char* p)
      : base(reinterpret_cast<bf16*>(p)) {}
  __device__ bf16* narrow_inv(int w, int part) const {
    return base + (w * kParts + part) * kNTile;
  }
  __device__ bf16* wide_inv(int w, int part) const {
    return base + kConsumers * kParts * kNTile + (w * kParts + part) * kWTile;
  }
  __device__ bf16* narrow(int s, int part) const {
    return base + kInv + s * kStage + part * kNTile;
  }
  __device__ bf16* wide(int s, int part) const {
    return base + kInv + s * kStage + kParts * kNTile + part * kWTile;
  }
  __device__ float* bias(int s) const {
    return reinterpret_cast<float*>(base + kTiles) + s * 2 * kTile;
  }
  __device__ float* rowterm(int s) const { return bias(s) + kTile; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(bias(0) + kScalars) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(kStages) + s; }
};

// Descriptors of a 64-row tile in the layout above for the k16-th step of
// K: K-major (K runs along the tile's columns) and MN-major (along its
// rows; wgmma's transposed B).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int k16) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) + k16 * 2 * kGroup,
                    kGroup, 128);
}
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int k16) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) + k16 * 256, 128,
                    kGroup);
}

// wgmma m64n64k16 with A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a.b, 64 x 64 over one k16 step, a and b from shared memory, each
// the sum of its hi and lo parts with kSplit (small terms first); scale_d
// = 0 overwrites d.
template <bool kSplit>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t ah, uint64_t al,
                                         uint64_t bh, uint64_t bl,
                                         int scale_d) {
  if (kSplit) {
    wgmma_ss_n64(d, al, bl, scale_d);
    wgmma_ss_n64(d, al, bh, 1);
    wgmma_ss_n64(d, ah, bl, 1);
    scale_d = 1;
  }
  wgmma_ss_n64(d, ah, bh, scale_d);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Arrives on bar once all of this thread's cp.asyncs so far have landed
// (the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// One TMA box (8 columns x 64 rows of example b) into 1 KB at dst.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// 8 values of a row from p (n of them valid, zero past them): bf16 with
// a 16-byte aligned whole row as its 16 bytes (raw), else as f32 (v).
template <typename T>
__device__ __forceinline__ bool load8(const T* p, int n, float (&v)[8],
                                      uint4& raw) {
  const bool vec = n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      raw = *reinterpret_cast<const uint4*>(p);
      return true;
    }
  } else if (vec) {
    const float4 x = reinterpret_cast<const float4*>(p)[0];
    const float4 y = reinterpret_cast<const float4*>(p)[1];
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
    return false;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < n ? to_f32(p[e]) : 0.f;
  return false;
}

// Plain loads of rows [r0, r0 + kTile) x columns [0, W) of a row-major
// [rows, width] block at src (row stride ld) into a tile, zero past `rows`
// and `width`, f32 split into hi and lo; thread `tid` of `nthreads`. A
// thread takes 8 columns of a row (one core-matrix row, 16 bytes), rows
// fastest, so a warp's stores are free of bank conflicts; it loads kBatch
// of them before it stores any, so their loads are in flight together.
template <typename T, int W, int kBatch = 4>
__device__ __forceinline__ void fill_plain(bf16* hi, bf16* lo, const T* src,
                                           int r0, int rows, int width,
                                           int ld, int tid, int nthreads) {
  constexpr bool kSplit = Traits<T>::kSplit;
  constexpr int kChunks = kTile * (W / 8);
  for (int i0 = tid; i0 < kChunks; i0 += kBatch * nthreads) {
    float v[kBatch][8];
    uint4 raw[kBatch];
    bool whole[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = i0 + k * nthreads, q = idx / kTile, r = idx % kTile;
      const bool ok = idx < kChunks && r0 + r < rows;
      whole[k] = load8(src + static_cast<long>(ok ? r0 + r : 0) * ld + q * 8,
                       ok ? width - q * 8 : 0, v[k], raw[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = i0 + k * nthreads;
      if (idx >= kChunks) break;
      uint4 h = raw[k], l;
      if (!whole[k]) {
        uint32_t* hw = &h.x;
        uint32_t* lw = &l.x;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pack<kSplit>(v[k][2 * e], v[k][2 * e + 1], hw[e], lw[e]);
      }
      const int off = (idx / kTile) * kGroup + (idx % kTile) * 16;
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(hi) + off) = h;
      if (kSplit)
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(lo) + off) = l;
    }
  }
}

// Producer thread pt's share of a ring stage: rows [r0, r0 + kTile) x
// columns [0, width) of the [rows, width] block at src (row stride ld; in
// the tensor map, from column col0 of example b). `how`: kTma, thread 0
// issues one box per column group (width % 8 == 0 then); 16, 8 or 4,
// cp.async of that many bytes (zero past `rows`); 0, fill_plain. Columns
// past `width` keep the zeros the prologue wrote, but for fill_plain,
// which writes them.
template <typename T, int W>
__device__ __forceinline__ void fill_tile(bf16* hi, bf16* lo, const T* src,
                                          int r0, int rows, int width,
                                          int ld, int how,
                                          const CUtensorMap* map, int col0,
                                          int b, uint64_t* bar, int pt) {
  if (how == kTma) {
    if (pt == 0)
      for (int q = 0; q < width / 8; ++q)
        tma_box(reinterpret_cast<char*>(hi) + q * kGroup, map, col0 + q * 8,
                r0, b, bar);
  } else if (how > 0) {
    const int per_row = width * 2 / how;
    for (int idx = pt; idx < kTile * per_row; idx += kProducers) {
      const int r = idx / per_row, bq = (idx - r * per_row) * how;
      const bool ok = r0 + r < rows;
      const char* s = reinterpret_cast<const char*>(
                          src + static_cast<long>(ok ? r0 + r : 0) * ld) +
                      bq;
      char* d = reinterpret_cast<char*>(hi) + (r % 8) * 16 + (r / 8) * 128 +
                bq % 16 + (bq / 16) * kGroup;
      if (how == 16)
        cp_async<16>(d, s, ok);
      else if (how == 8)
        cp_async<8>(d, s, ok);
      else
        cp_async<4>(d, s, ok);
    }
  } else {
    // f32 in batches of four rows a thread; bf16 comes here only for rows
    // too odd for cp.async, one at a time within the producer's registers.
    fill_plain<T, W, sizeof(T) == 4 ? 4 : 1>(hi, lo, src, r0, rows, width,
                                             ld, pt, kProducers);
  }
}

// The bytes TMA brings into a stage: 1 KB a column group of each operand
// it stages.
__device__ __forceinline__ int tma_bytes(int how_n, int wn, int how_w,
                                         int ww) {
  return ((how_n == kTma ? wn / 8 : 0) + (how_w == kTma ? ww / 8 : 0)) *
         kGroup;
}

// Before the roles split: the ring's tiles and scalars zeroed (padding
// columns and rows stay zero), the barriers initialised, and the
// block-invariant A operands staged by every thread: the narrow [rows, C]
// and wide [rows, cw] (row stride Cg) blocks at rows r0 + 64 w for
// consumer warpgroup w.
template <typename T, int CP, int GP>
__device__ __forceinline__ void bwd_prologue(const BwdSmem<T, CP, GP>& sm,
                                             const T* narrow, const T* wide,
                                             int r0, int rows, int C, int cw,
                                             int Cg) {
  using L = BwdSmem<T, CP, GP>;
  uint4* ring = reinterpret_cast<uint4*>(sm.narrow(0, 0));
  for (int i = threadIdx.x;
       i < (L::kStages * L::kStage * 2 + L::kScalars * 4) / 16;
       i += kBwdThreads)
    ring[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(sm.full(s), kProducers);
      mbar_init(sm.empty(s), 4 * kConsumers);
    }
  }
  for (int w = 0; w < kConsumers; ++w) {
    fill_plain<T, CP>(sm.narrow_inv(w, 0), sm.narrow_inv(w, L::kParts - 1),
                      narrow, r0 + w * kTile, rows, C, C, threadIdx.x,
                      kBwdThreads);
    fill_plain<T, GP>(sm.wide_inv(w, 0), sm.wide_inv(w, L::kParts - 1), wide,
                      r0 + w * kTile, rows, cw, Cg, threadIdx.x,
                      kBwdThreads);
  }
  fence_proxy_async();
  __syncthreads();
}

// The producer warpgroup: fills stage j % kStages for tiles j = 0 ..
// ntiles-1, once the consumers have freed it, and arrives on its full
// barrier: when its copies land, or, where it stored with plain loads
// (`plain`), after them (TMA's bytes complete the phase themselves).
template <typename L, typename Fill>
__device__ __forceinline__ void produce(const L& sm, int ntiles, bool plain,
                                        Fill fill) {
  setmaxnreg_dec<kProducerRegs>();
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % L::kStages;
    if (j >= L::kStages) mbar_wait(sm.empty(s), (j / L::kStages - 1) & 1);
    fill(j, s);
    if (plain) {
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(sm.full(s));
    } else {
      mbar_arrive_on_copies(sm.full(s));
    }
  }
}

// A consumer waits for stage s's j-th fill and makes what every proxy
// wrote there visible to its products.
template <typename L>
__device__ __forceinline__ void acquire(const L& sm, int j) {
  mbar_wait(sm.full(j % L::kStages), (j / L::kStages) & 1);
  fence_proxy_async();
}

// A consumer warp is done with stage s: its products on it have completed.
template <typename L>
__device__ __forceinline__ void release(const L& sm, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(sm.empty(s));
}

template <typename T, int CP, int GP>
__global__ void __launch_bounds__(kBwdThreads, 1)
attention_bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_phi,
                          const __grid_constant__ CUtensorMap tm_g,
                          const T* __restrict__ theta,
                          const T* __restrict__ phi, const T* __restrict__ g,
                          const T* __restrict__ dout,
                          const float* __restrict__ mx,
                          const float* __restrict__ den,
                          T* __restrict__ dtheta,
                          float* __restrict__ dtheta_parts,
                          float* __restrict__ row_out, int N, int M, int C,
                          int Cg, int chunk, int how_c, int how_g) {
  using L = BwdSmem<T, CP, GP>;
  constexpr bool kSplit = Traits<T>::kSplit;
  const L sm(smem);
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // This block's columns [c0, c0 + cw) of dout and g.
  const int c0 = blockIdx.z * chunk;
  const int cw = Cg - c0 < chunk ? Cg - c0 : chunk;
  const long bn = static_cast<long>(b) * N;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg + c0;
  const int ntiles = (M + kTile - 1) / kTile;
  bwd_prologue(sm, theta + bn * C, dout + bn * Cg + c0, blockIdx.x * kRows,
               N, C, cw, Cg);

  if (warp >= kProducerWarp) {
    const int pt = threadIdx.x - kProducerWarp * 32;
    auto fill = [&](int j, int s) {
      if (pt == 0 && tma_bytes(how_c, C, how_g, cw) > 0)
        mbar_expect_tx(sm.full(s), tma_bytes(how_c, C, how_g, cw));
      fill_tile<T, CP>(sm.narrow(s, 0), sm.narrow(s, L::kParts - 1), phi_b,
                       j * kTile, M, C, C, how_c, &tm_phi, 0, b, sm.full(s),
                       pt);
      fill_tile<T, GP>(sm.wide(s, 0), sm.wide(s, L::kParts - 1), g_b,
                       j * kTile, M, cw, Cg, how_g, &tm_g, c0, b, sm.full(s),
                       pt);
    };
    produce(sm, ntiles, how_c == 0 || how_g == 0, fill);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int w = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int r_w = blockIdx.x * kRows + w * kTile + (warp & 3) * 16;
  const bf16 *th_h = sm.narrow_inv(w, 0),
             *th_l = sm.narrow_inv(w, L::kParts - 1);
  const bf16 *do_h = sm.wide_inv(w, 0), *do_l = sm.wide_inv(w, L::kParts - 1);
  // P = ex2(s * log2(e) + nb) with nb = -(mx log2(e) + log2(den)); rows
  // beyond N have theta = 0 and nb = -inf, so P = 0 there. Keys beyond M
  // have phi = g = 0: P = ex2(nb) is finite there, and P*dP = 0 and
  // P.phi = 0 take nothing from them.
  float nb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_w + gq + 8 * i;
    nb[i] = row < N ? -fmaf(mx[bn + row], kLog2e, __log2f(den[bn + row]))
                    : -INFINITY;
  }
  float a1[CP / 8][4], a2[CP / 8][4];  // (P*dP).phi and P.phi
#pragma unroll
  for (int nt = 0; nt < CP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[nt][e] = a2[nt][e] = 0.f;
  float rsum[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % L::kStages;
    acquire(sm, j);
    const bf16 *ph = sm.narrow(s, 0), *pl = sm.narrow(s, L::kParts - 1);
    const bf16 *gh = sm.wide(s, 0), *gl = sm.wide(s, L::kParts - 1);
    float sc[kTile / 8][4], dp[kTile / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc)
      wgmma_ss<kSplit>(&sc[0][0], desc_k(th_h, kc), desc_k(th_l, kc),
                       desc_k(ph, kc), desc_k(pl, kc), kc > 0);
#pragma unroll
    for (int kc = 0; kc < GP / 16; ++kc)
      wgmma_ss<kSplit>(&dp[0][0], desc_k(do_h, kc), desc_k(do_l, kc),
                       desc_k(gh, kc), desc_k(gl, kc), kc > 0);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[nt][e], kLog2e, nb[e >> 1]));
        sc[nt][e] = p;
        dp[nt][e] *= p;
        rsum[e >> 1] += dp[nt][e];
      }
    FragA pa[kTile / 16], ta[kTile / 16];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      acc_to_a<true>(sc[2 * kk], sc[2 * kk + 1], pa[kk]);
      acc_to_a<true>(dp[2 * kk], dp[2 * kk + 1], ta[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_acc<true, kSplit, CP, 1>(&a1[0][0], ta[kk], desc_mn(ph, kk),
                                     desc_mn(pl, kk), 1);
      wgmma_acc<true, kSplit, CP, 1>(&a2[0][0], pa[kk], desc_mn(ph, kk),
                                     desc_mn(pl, kk), 1);
    }
    wgmma_commit();
    wgmma_wait();
    release(sm, s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
  }
  // One chunk: dtheta in the input type and row. Several: chunk z's f32
  // parts at [z, b, row]. Chunk 0 writes the exponent bias nb at [nz, b,
  // row] for the column pass.
  const bool parts = gridDim.z > 1;
  const long part = static_cast<long>(blockIdx.z) * gridDim.y * N;
  float* const bias_out =
      row_out + static_cast<long>(gridDim.z) * gridDim.y * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_w + gq + 8 * i;
    if (row >= N) continue;
#pragma unroll
    for (int nt = 0; nt < CP / 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = nt * 8 + 2 * t + q;
        if (c >= C) continue;
        const float v = a1[nt][2 * i + q] - rsum[i] * a2[nt][2 * i + q];
        if (parts)
          dtheta_parts[(part + bn + row) * C + c] = v;
        else
          store(dtheta, (bn + row) * C + c, v);
      }
    }
    if (t == 0) row_out[part + bn + row] = rsum[i];
    if (t == 0 && blockIdx.z == 0) bias_out[bn + row] = nb[i];
  }
}

template <typename T, int CP, int GP>
__global__ void __launch_bounds__(kBwdThreads, 1)
attention_bwd_cols_kernel(const __grid_constant__ CUtensorMap tm_theta,
                          const __grid_constant__ CUtensorMap tm_dout,
                          const T* __restrict__ theta,
                          const T* __restrict__ phi, const T* __restrict__ g,
                          const T* __restrict__ dout,
                          const float* __restrict__ row,
                          float* __restrict__ dphi, float* __restrict__ dg,
                          int N, int M, int C, int Cg, int chunk, int how_c,
                          int how_g) {
  using L = BwdSmem<T, CP, GP>;
  constexpr bool kSplit = Traits<T>::kSplit;
  const L sm(smem);
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // This block's columns [c0, c0 + cw) of dout, g and dg; chunk 0 alone
  // subtracts the row term from dP.
  const int c0 = blockIdx.z * chunk;
  const int cw = Cg - c0 < chunk ? Cg - c0 : chunk;
  const bool first = blockIdx.z == 0;
  const long bn = static_cast<long>(b) * N, bm = static_cast<long>(b) * M;
  const T* theta_b = theta + bn * C;
  const T* dout_b = dout + bn * Cg + c0;
  const int ntiles = (N + kTile - 1) / kTile;
  // Keys beyond M: phi and g are zero there and their rows are not stored.
  bwd_prologue(sm, phi + bm * C, g + bm * Cg + c0, blockIdx.x * kRows, M, C,
               cw, Cg);

  // The rows' exponent bias, written by the row pass after the nz parts
  // of the row term; part 0 of those is their sum.
  const float* bias_in = row + static_cast<long>(gridDim.z) * gridDim.y * N;
  if (warp >= kProducerWarp) {
    const int pt = threadIdx.x - kProducerWarp * 32;
    auto fill = [&](int j, int s) {
      // Rows past N stage zeros: theta and dout are zero there too, so
      // P = ex2(0) = 1 meets dP = 0 and dout = 0 and adds nothing.
      const int n = j * kTile + pt % kTile;
      if (pt < kTile || first)
        cp_async<4>((pt < kTile ? sm.bias(s) : sm.rowterm(s)) + pt % kTile,
                    (pt < kTile ? bias_in : row) + bn + (n < N ? n : 0),
                    n < N);
      if (pt == 0 && tma_bytes(how_c, C, how_g, cw) > 0)
        mbar_expect_tx(sm.full(s), tma_bytes(how_c, C, how_g, cw));
      fill_tile<T, CP>(sm.narrow(s, 0), sm.narrow(s, L::kParts - 1), theta_b,
                       j * kTile, N, C, C, how_c, &tm_theta, 0, b, sm.full(s),
                       pt);
      fill_tile<T, GP>(sm.wide(s, 0), sm.wide(s, L::kParts - 1), dout_b,
                       j * kTile, N, cw, Cg, how_g, &tm_dout, c0, b,
                       sm.full(s), pt);
    };
    produce(sm, ntiles, how_c == 0 || how_g == 0, fill);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int w = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int k_w = blockIdx.x * kRows + w * kTile + (warp & 3) * 16;
  const bf16 *ph_h = sm.narrow_inv(w, 0),
             *ph_l = sm.narrow_inv(w, L::kParts - 1);
  const bf16 *g_h = sm.wide_inv(w, 0), *g_l = sm.wide_inv(w, L::kParts - 1);
  float dph[CP / 8][4], dgv[GP / 8][4];
#pragma unroll
  for (int nt = 0; nt < CP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dph[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < GP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dgv[nt][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % L::kStages;
    acquire(sm, j);
    const bf16 *thh = sm.narrow(s, 0), *thl = sm.narrow(s, L::kParts - 1);
    const bf16 *doh = sm.wide(s, 0), *dol = sm.wide(s, L::kParts - 1);
    const float *bias = sm.bias(s), *rw = sm.rowterm(s);
    float sc[kTile / 8][4], dp[kTile / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc)
      wgmma_ss<kSplit>(&sc[0][0], desc_k(ph_h, kc), desc_k(ph_l, kc),
                       desc_k(thh, kc), desc_k(thl, kc), kc > 0);
#pragma unroll
    for (int kc = 0; kc < GP / 16; ++kc)
      wgmma_ss<kSplit>(&dp[0][0], desc_k(g_h, kc), desc_k(g_l, kc),
                       desc_k(doh, kc), desc_k(dol, kc), kc > 0);
    wgmma_commit();
    wgmma_wait();
    // Element e of n-tile nt is (key, row n = nt*8 + 2t + (e & 1)).
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = nt * 8 + 2 * t + q;
        const float bv = bias[n], rv = rw[n];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + q;
          const float p = ex2(fmaf(sc[nt][e], kLog2e, bv));
          sc[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - rv);
        }
      }
    FragA pa[kTile / 16], dsa[kTile / 16];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      acc_to_a<kSplit>(sc[2 * kk], sc[2 * kk + 1], pa[kk]);
      acc_to_a<true>(dp[2 * kk], dp[2 * kk + 1], dsa[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_acc<true, kSplit, CP, 1>(&dph[0][0], dsa[kk], desc_mn(thh, kk),
                                     desc_mn(thl, kk), 1);
      wgmma_acc<kSplit, kSplit, GP, 1>(&dgv[0][0], pa[kk], desc_mn(doh, kk),
                                       desc_mn(dol, kk), 1);
    }
    wgmma_commit();
    wgmma_wait();
    release(sm, s);
  }

  // dphi is [nz, B, M, C]: the output itself with one chunk, its f32 parts
  // with several.
  const long part = static_cast<long>(blockIdx.z) * gridDim.y * M;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k_w + gq + 8 * i;
    if (key >= M) continue;
#pragma unroll
    for (int nt = 0; nt < CP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < C) dphi[(part + bm + key) * C + c] = dph[nt][2 * i];
      if (c + 1 < C) dphi[(part + bm + key) * C + c + 1] = dph[nt][2 * i + 1];
    }
#pragma unroll
    for (int nt = 0; nt < GP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < cw) dg[(bm + key) * Cg + c0 + c] = dgv[nt][2 * i];
      if (c + 1 < cw) dg[(bm + key) * Cg + c0 + c + 1] = dgv[nt][2 * i + 1];
    }
  }
}

// The kernels at C > 64 (the object compiled with CGT_WIDE). C is cut into
// nc = ceil(C / kCW) chunks of kCW = 64 columns, the last zero-padded to a
// multiple of 16, and the CP = 64 geometry above loops over them in the
// same shared memory: S = theta.phi^T (S^T = phi.theta^T in the column
// pass) needs all of C before its exponentials, so a block sums it over
// the chunks, one pipeline step per (tile, chunk), staging phi's (theta's)
// chunk where the CP = 64 kernels stage all of it and reading theta's
// (phi's) chunk fragments from device memory each step (no A fragments of
// all of C stay in registers). The forward has no output of C columns, so
// only its score product loops. The backward's dtheta and dphi have C
// columns, and a warp's f32 accumulators of more than 64 outgrow the
// registers: a block accumulates one chunk of them, blockIdx.z = z_g * nc
// + z_c (z_g the column chunk of Cg, z_c that of C), and every block
// recomputes S over all of C with its own chunk staged last, so that the
// products read it from the tile S left there. The chunks' columns are
// disjoint: the f32 parts of the Cg chunks and their sums take them as
// they are, still without atomics. Cost: each extra C chunk recomputes S
// and its exponentials in the backward.
constexpr int kCW = 64;

__device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }

template <typename T, int GP>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_wide_kernel(const T* __restrict__ theta,
                          const T* __restrict__ phi, const T* __restrict__ g,
                          T* __restrict__ out, float* __restrict__ mx_out,
                          float* __restrict__ den_out, int N, int M, int C,
                          int Cg, int chunk, int vec_c, int vec_g) {
  using R = Ring<T>;
  constexpr bool kSplit = R::kSplit;
  constexpr int kPhiRowGroup = kCW / 8 * 128, kGColGroup = kTile / 8 * 128;
  constexpr int kPhiTile = kTile * kCW, kGTile = kTile * GP;
  bf16* const phi_s = reinterpret_cast<bf16*>(smem);  // [kBuf][kParts]
  bf16* const g_s = phi_s + R::kBuf * R::kParts * kPhiTile;
  auto phi_at = [&](int buf, int part) {
    return phi_s + (buf * R::kParts + part) * kPhiTile;
  };
  auto g_at = [&](int buf, int part) {
    return g_s + (buf * R::kParts + part) * kGTile;
  };

  const int b = blockIdx.y, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const int c0 = blockIdx.z * chunk;
  const int cw = Cg - c0 < chunk ? Cg - c0 : chunk;
  const int nc = (C + kCW - 1) / kCW;
  const T* theta_b = theta + static_cast<long>(b) * N * C;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg + c0;

  if (!kSplit) {
    zero(phi_s, R::kBuf * R::kParts * (kPhiTile + kGTile));
    __syncthreads();
  }

  float o[GP / 8][4];
#pragma unroll
  for (int nt = 0; nt < GP / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kTile / 8][4];  // the key tile's S, summed over the C chunks

  // Step i: C chunk i % nc of key tile i / nc; g's tile with the last.
  auto issue = [&](int i, int buf) {
    const int j = i / nc, cc = (i - j * nc) * kCW;
    const int w = C - cc < kCW ? C - cc : kCW;
    stage_cm<T, kCW, kPhiRowGroup, 128, true>(
        phi_at(buf, 0), phi_at(buf, R::kParts - 1), phi_b + cc, j * kTile, M,
        w, C, vec_c, round16(w));
    if (cc + kCW >= C)
      stage_cm<T, GP, 128, kGColGroup>(g_at(buf, 0),
                                       g_at(buf, R::kParts - 1), g_b,
                                       j * kTile, M, cw, Cg, vec_g);
  };
  auto body = [&](int i, int buf) {
    const int j = i / nc, kc = i - j * nc, cc = kc * kCW;
    const bf16 *ph = phi_at(buf, 0), *phl = phi_at(buf, R::kParts - 1);
    FragA th[kCW / 16];
#pragma unroll
    for (int kk = 0; kk < kCW / 16; ++kk)
      if (cc + kk * 16 < C)
        load_a(theta_b, r0, N, cc + kk * 16, C, C, th[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCW / 16; ++kk)
      if (cc + kk * 16 < C)
        wgmma_acc<kSplit, kSplit, kTile, 0>(
            &s[0][0], th[kk], wgmma_desc(ph + kk * 128, 128, kPhiRowGroup),
            wgmma_desc(phl + kk * 128, 128, kPhiRowGroup), kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait();
    if (kc == nc - 1)
      fwd_tile<kSplit, GP>(s, o, m, l, g_at(buf, 0),
                           g_at(buf, R::kParts - 1), j * kTile, M);
  };
  pipeline<T>((M + kTile - 1) / kTile * nc, issue, body);
  fwd_store<T, GP>(o, m, l, out, mx_out, den_out, b, r0, N, Cg, c0, cw,
                   blockIdx.z == 0);
}

template <typename T, int GP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_rows_wide_kernel(const T* __restrict__ theta,
                               const T* __restrict__ phi,
                               const T* __restrict__ g,
                               const T* __restrict__ dout,
                               const float* __restrict__ mx,
                               const float* __restrict__ den,
                               T* __restrict__ dtheta,
                               float* __restrict__ dtheta_parts,
                               float* __restrict__ row_out, int N, int M,
                               int C, int Cg, int chunk, int vec_c,
                               int vec_g) {
  using R = Ring<T>;
  constexpr bool kSplit = R::kSplit;
  constexpr int CS = kCW + 8, GS = GP + 8;
  constexpr int kPhiTile = kTile * CS, kGTile = kTile * GS;
  bf16* const phi_s = reinterpret_cast<bf16*>(smem);  // [kBuf][kParts]
  bf16* const g_s = phi_s + R::kBuf * R::kParts * kPhiTile;
  auto phi_at = [&](int buf, int part) {
    return phi_s + (buf * R::kParts + part) * kPhiTile;
  };
  auto g_at = [&](int buf, int part) {
    return g_s + (buf * R::kParts + part) * kGTile;
  };

  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, r0 = blockIdx.x * kRows + warp * 16;
  const int nc = (C + kCW - 1) / kCW;
  const int zg = blockIdx.z / nc, zc = blockIdx.z - zg * nc;
  // This block's columns [c0, c0 + cw) of dout and g, and [cc0, cc0 + ccw)
  // of dtheta.
  const int c0 = zg * chunk;
  const int cw = Cg - c0 < chunk ? Cg - c0 : chunk;
  const int cc0 = zc * kCW;
  const int ccw = C - cc0 < kCW ? C - cc0 : kCW;
  const T* theta_b = theta + static_cast<long>(b) * N * C;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg + c0;
  const T* dout_b = dout + static_cast<long>(b) * N * Cg + c0;
  // The first column of the C chunk of step kc of a tile: this block's own
  // chunk comes last.
  auto chunk_at = [&](int kc) {
    const int z = zc + 1 + kc;
    return (z < nc ? z : z - nc) * kCW;
  };

  if (!kSplit) {
    zero(phi_s, R::kBuf * R::kParts * (kPhiTile + kGTile));
    __syncthreads();
  }

  float nb[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    const bool ok = row < N;
    nb[i] = ok ? -mx[static_cast<long>(b) * N + row] * kLog2e : 0.f;
    inv[i] = ok ? 1.f / den[static_cast<long>(b) * N + row] : 0.f;
  }

  float a1[kCW / 8][4], a2[kCW / 8][4];  // (P*dP).phi and P.phi
#pragma unroll
  for (int nt = 0; nt < kCW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[nt][e] = a2[nt][e] = 0.f;
  float rsum[2] = {0.f, 0.f};
  float s[kTile / 8][4];  // the key tile's S, summed over the C chunks

  auto issue = [&](int i, int buf) {
    const int j = i / nc, kc = i - j * nc, cc = chunk_at(kc);
    const int w = C - cc < kCW ? C - cc : kCW;
    stage<T, kCW, CS, true>(phi_at(buf, 0), phi_at(buf, R::kParts - 1),
                            phi_b + cc, j * kTile, M, w, C, vec_c,
                            round16(w));
    if (kc == nc - 1)
      stage<T, GP, GS>(g_at(buf, 0), g_at(buf, R::kParts - 1), g_b,
                       j * kTile, M, cw, Cg, vec_g);
  };
  auto body = [&](int i, int buf) {
    const int j = i / nc, kc = i - j * nc, cc = chunk_at(kc);
    const bf16 *ph = phi_at(buf, 0), *phl = phi_at(buf, R::kParts - 1);
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    {
      FragA th[kCW / 16];
#pragma unroll
      for (int kk = 0; kk < kCW / 16; ++kk)
        if (cc + kk * 16 < C)
          load_a(theta_b, r0, N, cc + kk * 16, C, C, th[kk]);
#pragma unroll
      for (int ks = 0; ks < kTile; ks += 16)
#pragma unroll
        for (int kk = 0; kk < kCW / 16; ++kk)
          if (cc + kk * 16 < C) {
            FragB b0, b1;
            load_b_nk2<kSplit, CS>(ph, phl, ks, kk * 16, b0, b1);
            mma<kSplit>(s[ks / 8], th[kk], b0);
            mma<kSplit>(s[ks / 8 + 1], th[kk], b1);
          }
    }
    if (kc != nc - 1) return;
    // The tile's S is whole, and phi's tile holds this block's chunk.
    const bf16 *gh = g_at(buf, 0), *gl = g_at(buf, R::kParts - 1);
    FragA dO[GP / 16];
#pragma unroll
    for (int kq = 0; kq < GP / 16; ++kq)
      load_a(dout_b, r0, N, kq * 16, cw, Cg, dO[kq]);
#pragma unroll
    for (int ks = 0; ks < kTile; ks += 16) {
      float dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < GP / 16; ++kq) {
        FragB b0, b1;
        load_b_nk2<kSplit, GS>(gh, gl, ks, kq * 16, b0, b1);
        mma<kSplit>(dp[0], dO[kq], b0);
        mma<kSplit>(dp[1], dO[kq], b1);
      }
      const int key0 = j * kTile + ks;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& sv = s[ks / 8 + nt][e];
          const float p =
              key0 + nt * 8 + 2 * t + (e & 1) < M
                  ? ex2(fmaf(sv, kLog2e, nb[e >> 1])) * inv[e >> 1]
                  : 0.f;
          sv = p;
          dp[nt][e] *= p;
          rsum[e >> 1] += dp[nt][e];
        }
      // P and P*dP as hi + lo parts, as in the row pass above.
      FragA pa, ta;
      acc_to_a<true>(s[ks / 8], s[ks / 8 + 1], pa);
      acc_to_a<true>(dp[0], dp[1], ta);
#pragma unroll
      for (int np = 0; np < kCW / 16; ++np)
        if (np * 16 < ccw) {
          FragB b0, b1;
          load_b_kn2<kSplit, CS>(ph, phl, ks, np * 16, b0, b1);
          mma<true, kSplit>(a1[2 * np], ta, b0);
          mma<true, kSplit>(a1[2 * np + 1], ta, b1);
          mma<true, kSplit>(a2[2 * np], pa, b0);
          mma<true, kSplit>(a2[2 * np + 1], pa, b1);
        }
    }
  };
  pipeline<T>((M + kTile - 1) / kTile * nc, issue, body);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
  }
  // One Cg chunk: dtheta in the input type and row. Several: Cg chunk
  // z_g's f32 parts at [z_g, b, row]. The C chunk z_c = 0 writes row.
  const bool parts = static_cast<int>(gridDim.z) > nc;
  const long part = static_cast<long>(zg) * gridDim.y * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    if (row >= N) continue;
    const long bn = static_cast<long>(b) * N + row;
#pragma unroll
    for (int nt = 0; nt < kCW / 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = nt * 8 + 2 * t + q;
        if (c >= ccw) continue;
        const float v = a1[nt][2 * i + q] - rsum[i] * a2[nt][2 * i + q];
        if (parts)
          dtheta_parts[(part + bn) * C + cc0 + c] = v;
        else
          store(dtheta, bn * C + cc0 + c, v);
      }
    }
    if (t == 0 && zc == 0) row_out[part + bn] = rsum[i];
  }
}

template <typename T, int GP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_cols_wide_kernel(const T* __restrict__ theta,
                               const T* __restrict__ phi,
                               const T* __restrict__ g,
                               const T* __restrict__ dout,
                               const float* __restrict__ mx,
                               const float* __restrict__ den,
                               const float* __restrict__ row,
                               float* __restrict__ dphi,
                               float* __restrict__ dg, int N, int M, int C,
                               int Cg, int chunk, int vec_c, int vec_g) {
  using R = Ring<T>;
  constexpr bool kSplit = R::kSplit;
  constexpr int CS = kCW + 8, GS = GP + 8;
  constexpr int kThTile = kTile * CS, kDoTile = kTile * GS;
  bf16* const th_s = reinterpret_cast<bf16*>(smem);  // [kBuf][kParts]
  bf16* const do_s = th_s + R::kBuf * R::kParts * kThTile;
  // mx, den, row: [kBuf][3][kTile]
  float* const sc_s = reinterpret_cast<float*>(
      do_s + R::kBuf * R::kParts * kDoTile);
  auto th_at = [&](int buf, int part) {
    return th_s + (buf * R::kParts + part) * kThTile;
  };
  auto do_at = [&](int buf, int part) {
    return do_s + (buf * R::kParts + part) * kDoTile;
  };
  auto sc_at = [&](int buf, int k) { return sc_s + (buf * 3 + k) * kTile; };

  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, k0 = blockIdx.x * kRows + warp * 16;
  const int nc = (C + kCW - 1) / kCW;
  const int zg = blockIdx.z / nc, zc = blockIdx.z - zg * nc;
  // This block's columns [c0, c0 + cw) of dout, g and dg (which the C
  // chunk z_c = 0 writes), and [cc0, cc0 + ccw) of dphi; the Cg chunk
  // z_g = 0 alone subtracts the row term from dP.
  const int c0 = zg * chunk;
  const int cw = Cg - c0 < chunk ? Cg - c0 : chunk;
  const int cc0 = zc * kCW;
  const int ccw = C - cc0 < kCW ? C - cc0 : kCW;
  const bool first = zg == 0, with_dg = zc == 0;
  const long bn = static_cast<long>(b) * N;
  const T* theta_b = theta + bn * C;
  const T* dout_b = dout + bn * Cg + c0;
  const T* phi_b = phi + static_cast<long>(b) * M * C;
  const T* g_b = g + static_cast<long>(b) * M * Cg + c0;
  auto chunk_at = [&](int kc) {
    const int z = zc + 1 + kc;
    return (z < nc ? z : z - nc) * kCW;
  };

  if (!kSplit) {
    zero(th_s, R::kBuf * R::kParts * (kThTile + kDoTile));
    __syncthreads();
  }

  float dph[kCW / 8][4], dgv[GP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kCW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dph[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < GP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dgv[nt][e] = 0.f;
  float s[kTile / 8][4];  // the row tile's S^T, summed over the C chunks

  auto issue = [&](int i, int buf) {
    const int j = i / nc, kc = i - j * nc, cc = chunk_at(kc);
    const int w = C - cc < kCW ? C - cc : kCW;
    stage<T, kCW, CS, true>(th_at(buf, 0), th_at(buf, R::kParts - 1),
                            theta_b + cc, j * kTile, N, w, C, vec_c,
                            round16(w));
    if (kc == nc - 1) {
      stage<T, GP, GS>(do_at(buf, 0), do_at(buf, R::kParts - 1), dout_b,
                       j * kTile, N, cw, Cg, vec_g);
      stage_scalars(sc_at(buf, 0), mx + bn, j * kTile, N);
      stage_scalars(sc_at(buf, 1), den + bn, j * kTile, N);
      stage_scalars(sc_at(buf, 2), row + bn, j * kTile, N);
    }
  };
  auto body = [&](int i, int buf) {
    const int j = i / nc, kc = i - j * nc, cc = chunk_at(kc);
    const bf16 *thh = th_at(buf, 0), *thl = th_at(buf, R::kParts - 1);
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    {
      FragA pf[kCW / 16];
#pragma unroll
      for (int kk = 0; kk < kCW / 16; ++kk)
        if (cc + kk * 16 < C)
          load_a(phi_b, k0, M, cc + kk * 16, C, C, pf[kk]);
#pragma unroll
      for (int rs = 0; rs < kTile; rs += 16)
#pragma unroll
        for (int kk = 0; kk < kCW / 16; ++kk)
          if (cc + kk * 16 < C) {
            FragB b0, b1;
            load_b_nk2<kSplit, CS>(thh, thl, rs, kk * 16, b0, b1);
            mma<kSplit>(s[rs / 8], pf[kk], b0);
            mma<kSplit>(s[rs / 8 + 1], pf[kk], b1);
          }
    }
    if (kc != nc - 1) return;
    // The tile's S^T is whole, and theta's tile holds this block's chunk.
    const bf16 *doh = do_at(buf, 0), *dol = do_at(buf, R::kParts - 1);
    const float *mx_t = sc_at(buf, 0), *den_t = sc_at(buf, 1),
                *row_t = sc_at(buf, 2);
    FragA ga[GP / 16];
#pragma unroll
    for (int kq = 0; kq < GP / 16; ++kq)
      load_a(g_b, k0, M, kq * 16, cw, Cg, ga[kq]);
#pragma unroll
    for (int rs = 0; rs < kTile; rs += 16) {
      float dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
      for (int kq = 0; kq < GP / 16; ++kq) {
        FragB b0, b1;
        load_b_nk2<kSplit, GS>(doh, dol, rs, kq * 16, b0, b1);
        mma<kSplit>(dp[0], ga[kq], b0);
        mma<kSplit>(dp[1], ga[kq], b1);
      }
      // Element e of n-tile nt is (key, row n = rs + nt*8 + 2t + (e & 1)).
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = rs + nt * 8 + 2 * t + q;
          const bool ok = j * kTile + n < N;
          const float nbv = -mx_t[n] * kLog2e;
          const float iv = ok ? __frcp_rn(den_t[n]) : 0.f;
          const float rw = first ? row_t[n] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + q;
            float& sv = s[rs / 8 + nt][e];
            const float p = ok ? ex2(fmaf(sv, kLog2e, nbv)) * iv : 0.f;
            sv = p;
            dp[nt][e] = p * (dp[nt][e] - rw);
          }
        }
      // P and dS as hi + lo parts, as in the column pass above.
      FragA pa, dsa;
      acc_to_a<true>(s[rs / 8], s[rs / 8 + 1], pa);
      acc_to_a<true>(dp[0], dp[1], dsa);
#pragma unroll
      for (int np = 0; np < kCW / 16; ++np)
        if (np * 16 < ccw) {
          FragB b0, b1;
          load_b_kn2<kSplit, CS>(thh, thl, rs, np * 16, b0, b1);
          mma<true, kSplit>(dph[2 * np], dsa, b0);
          mma<true, kSplit>(dph[2 * np + 1], dsa, b1);
        }
      if (with_dg) {
#pragma unroll
        for (int np = 0; np < GP / 16; ++np) {
          FragB b0, b1;
          load_b_kn2<kSplit, GS>(doh, dol, rs, np * 16, b0, b1);
          mma<true, kSplit>(dgv[2 * np], pa, b0);
          mma<true, kSplit>(dgv[2 * np + 1], pa, b1);
        }
      }
    }
  };
  pipeline<T>((N + kTile - 1) / kTile * nc, issue, body);

  // dphi is [nz, B, M, C]: the output itself with one Cg chunk, its f32
  // parts with several.
  const long part = static_cast<long>(zg) * gridDim.y * M;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + (lane >> 2) + 8 * i;
    if (key >= M) continue;
    const long bm = static_cast<long>(b) * M + key;
#pragma unroll
    for (int nt = 0; nt < kCW / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < ccw) dphi[(part + bm) * C + cc0 + c] = dph[nt][2 * i];
      if (c + 1 < ccw)
        dphi[(part + bm) * C + cc0 + c + 1] = dph[nt][2 * i + 1];
    }
    if (!with_dg) continue;
#pragma unroll
    for (int nt = 0; nt < GP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < cw) dg[bm * Cg + c0 + c] = dgv[nt][2 * i];
      if (c + 1 < cw) dg[bm * Cg + c0 + c + 1] = dgv[nt][2 * i + 1];
    }
  }
}

// Bytes per cp.async for rows of a bf16 matrix at p of row stride ld, read
// in column chunks of `chunk` (the last `last` wide): the largest of 16, 8
// or 4 that divides the address and every row's and chunk's bytes; 0 when
// none does (or for f32, which is staged with plain loads).
int vec_bytes(const void* p, int ld, int chunk, int last, bool is_bf16) {
  if (!is_bf16) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2)
    if ((ld * 2) % v == 0 && (chunk * 2) % v == 0 && (last * 2) % v == 0 &&
        a % v == 0)
      return v;
  return 0;
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
int allow_smem(K* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// cuTensorMapEncodeTiled of the driver, found through the runtime (no link
// against libcuda); null if the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// How the backward stages a tile operand [B, rows, ld] at p whose columns
// it reads in chunks of `chunk` (the last `last` wide): kTma, with `map`
// encoded as a 3-D view [B][rows][ld] of boxes of 64 rows x 8 columns,
// when the rows are bf16 of a multiple of 8 elements (16 bytes, as TMA
// needs) in chunks of a multiple of 8 at a 16-byte aligned base; else
// vec_bytes (cp.async, or 0 for plain loads). Returns a CUDA error if such
// an operand's map cannot be encoded: no other staging stands in for it.
int tile_how(CUtensorMap* map, const void* p, int B, int rows, int ld,
             int chunk, int last, bool is_bf16, int* how) {
  *how = vec_bytes(p, ld, chunk, last, is_bf16);
  if (!is_bf16 || ld % 8 != 0 || chunk % 8 != 0 || last % 8 != 0 ||
      reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(rows) * ld * 2};
  const cuuint32_t box[3] = {8, kTile, 1}, steps[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  *how = kTma;
  return 0;
}

// The kernels of a launch: those at C padded to CP, or with kWide those
// that loop over C chunks (CP = kCW).
template <typename T, int CP, int GP, bool kWide>
struct Kernels {
  static constexpr auto fwd = attention_fwd_kernel<T, CP, GP>;
  static constexpr auto rows = attention_bwd_rows_kernel<T, CP, GP>;
  static constexpr auto cols = attention_bwd_cols_kernel<T, CP, GP>;
};
template <typename T, int GP>
struct Kernels<T, kCW, GP, true> {
  static constexpr auto fwd = attention_fwd_wide_kernel<T, GP>;
  static constexpr auto rows = attention_bwd_rows_wide_kernel<T, GP>;
  static constexpr auto cols = attention_bwd_cols_wide_kernel<T, GP>;
};

// The backward passes at C <= 64: 288 threads a block, the operand tiles'
// staging chosen per launch (tile_how).
template <typename T, int CP, int GP>
int launch_bwd(const Args& a, int kind) {
  using K = Kernels<T, CP, GP, false>;
  constexpr int bytes = BwdSmem<T, CP, GP>::kBytes;
  const bool rows_pass = kind == cgt::kRowsPass;
  const int nz = a.nz(), last = a.Cg - (nz - 1) * a.chunk;
  const int trows = rows_pass ? a.M : a.N;  // rows of the tile operands
  CUtensorMap tm_c{}, tm_g{};
  int how_c, how_g;
  int err = tile_how(&tm_c, rows_pass ? a.phi : a.theta, a.B, trows, a.C,
                     a.C, a.C, a.bf16, &how_c);
  if (err != 0) return err;
  err = tile_how(&tm_g, rows_pass ? a.g : a.dout, a.B, trows, a.Cg, a.chunk,
                 last, a.bf16, &how_g);
  if (err != 0) return err;
  const T *theta = static_cast<const T*>(a.theta),
          *phi = static_cast<const T*>(a.phi), *g = static_cast<const T*>(a.g),
          *dout = static_cast<const T*>(a.dout);
  if (rows_pass) {
    const auto kernel = K::rows;
    err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    const dim3 grid((a.N + kRows - 1) / kRows, a.B, nz);
    kernel<<<grid, kBwdThreads, bytes, a.stream>>>(
        tm_c, tm_g, theta, phi, g, dout, a.mx_in, a.den_in,
        static_cast<T*>(a.dtheta), a.dtheta_parts, a.row, a.N, a.M, a.C, a.Cg,
        a.chunk, how_c, how_g);
  } else {
    const auto kernel = K::cols;
    err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    const dim3 grid((a.M + kRows - 1) / kRows, a.B, nz);
    kernel<<<grid, kBwdThreads, bytes, a.stream>>>(
        tm_c, tm_g, theta, phi, g, dout, a.row,
        nz > 1 ? a.dphi_parts : a.dphi, a.dg, a.N, a.M, a.C, a.Cg, a.chunk,
        how_c, how_g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CP, int GP, bool kWide>
int launch(const Args& a, int kind) {
  if constexpr (!kWide) {
    if (kind != cgt::kFwd) return launch_bwd<T, CP, GP>(a, kind);
  }
  using K = Kernels<T, CP, GP, kWide>;
  constexpr int kParts = Ring<T>::kBuf * Ring<T>::kParts;  // tiles a ring
  const int nz = a.nz(), last = a.Cg - (nz - 1) * a.chunk;
  // The wide backward's blocks also run over nc chunks of C.
  const int cc = kWide ? kCW : a.C, nc = (a.C + cc - 1) / cc;
  const int nzc = kind == cgt::kFwd ? nz : nz * nc;
  if (nzc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_g = vec_bytes(kind == cgt::kColsPass ? a.dout : a.g, a.Cg,
                              a.chunk, last, a.bf16);
  const int vec_c = vec_bytes(kind == cgt::kColsPass ? a.theta : a.phi, a.C,
                              cc, a.C - (nc - 1) * cc, a.bf16);
  const dim3 grid_rows((a.N + kRows - 1) / kRows, a.B, nzc);
  if (kind == cgt::kFwd) {
    constexpr int bytes = kParts * kTile * (CP + GP) * sizeof(bf16);
    const auto kernel = K::fwd;
    int err = allow_smem(kernel, bytes);
    if (err != 0) return err;
    kernel<<<grid_rows, kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
        static_cast<const T*>(a.g), static_cast<T*>(a.out), a.mx, a.den, a.N,
        a.M, a.C, a.Cg, a.chunk, vec_c, vec_g);
  } else if constexpr (kWide) {
    if (kind == cgt::kRowsPass) {
      constexpr int bytes = kParts * kTile * (CP + GP + 16) * sizeof(bf16);
      const auto kernel = K::rows;
      int err = allow_smem(kernel, bytes);
      if (err != 0) return err;
      kernel<<<grid_rows, kThreads, bytes, a.stream>>>(
          static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
          static_cast<const T*>(a.g), static_cast<const T*>(a.dout), a.mx_in,
          a.den_in, static_cast<T*>(a.dtheta), a.dtheta_parts, a.row, a.N,
          a.M, a.C, a.Cg, a.chunk, vec_c, vec_g);
    } else {
      constexpr int bytes = kParts * kTile * (CP + GP + 16) * sizeof(bf16) +
                            Ring<T>::kBuf * 3 * kTile * sizeof(float);
      const auto kernel = K::cols;
      int err = allow_smem(kernel, bytes);
      if (err != 0) return err;
      const dim3 grid_cols((a.M + kRows - 1) / kRows, a.B, nzc);
      kernel<<<grid_cols, kThreads, bytes, a.stream>>>(
          static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
          static_cast<const T*>(a.g), static_cast<const T*>(a.dout), a.mx_in,
          a.den_in, a.row, nz > 1 ? a.dphi_parts : a.dphi, a.dg, a.N, a.M,
          a.C, a.Cg, a.chunk, vec_c, vec_g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The chunk width pads to the narrowest GP that holds it.
template <typename T, int CP, bool kWide>
int launch_gp(const Args& a, int kind) {
  if (a.chunk <= 48) return launch<T, CP, 48, kWide>(a, kind);
  if (a.chunk <= 96) return launch<T, CP, 96, kWide>(a, kind);
  if (a.chunk <= cgt::kMaxChunk) return launch<T, CP, 128, kWide>(a, kind);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

namespace cgt {

#ifdef CGT_WIDE
template <typename T>
int launch_wide(const Args& a, int kind) {
  return launch_gp<T, kCW, true>(a, kind);
}

template int launch_wide<float>(const Args&, int);
template int launch_wide<bf16>(const Args&, int);
#else
template <typename T, int CP>
int launch_cp(const Args& a, int kind) {
  return launch_gp<T, CP, false>(a, kind);
}

template int launch_cp<float, CGT_CP>(const Args&, int);
template int launch_cp<bf16, CGT_CP>(const Args&, int);
#endif

}  // namespace cgt

#else  // The entry object: dispatch on C, the sum of the parts, the C API.

namespace {

using cgt::Args;

__device__ __forceinline__ void put(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void put(bf16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// out[i] = sum over z of parts[z * n + i], in z order, in f32, stored in
// TOut. out may be part 0 itself (each element is read before written).
template <typename TOut>
__global__ void sum_parts_kernel(const float* parts, TOut* out, long n,
                                 int nz) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long>(gridDim.x) * blockDim.x) {
    float s = parts[i];
    for (int z = 1; z < nz; ++z) s += parts[z * n + i];
    put(out, i, s);
  }
}

template <typename TOut>
int sum_parts(const float* parts, TOut* out, long n, int nz,
              cudaStream_t stream) {
  const long blocks = (n + 255) / 256;
  sum_parts_kernel<TOut><<<blocks < 1056 ? blocks : 1056, 256, 0, stream>>>(
      parts, out, n, nz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_c(const Args& a, int kind) {
  if (a.C <= 16) return cgt::launch_cp<T, 16>(a, kind);
  if (a.C <= 32) return cgt::launch_cp<T, 32>(a, kind);
  if (a.C <= 48) return cgt::launch_cp<T, 48>(a, kind);
  if (a.C <= 64) return cgt::launch_cp<T, 64>(a, kind);
  return cgt::launch_wide<T>(a, kind);
}

int launch(const Args& a, int kind) {
  if (a.C < 1 || a.Cg < 1 || a.chunk < 1 || a.chunk > cgt::kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  return a.bf16 ? launch_c<bf16>(a, kind) : launch_c<float>(a, kind);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `chunk` is
// the width of Cg's column chunks (at most 128).
int cgt_attention_fwd(const void* theta, const void* phi, const void* g,
                      void* out, void* mx, void* den, int B, int N, int M,
                      int C, int Cg, int chunk, int is_bf16, void* stream) {
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
  a.chunk = chunk;
  a.bf16 = is_bf16 != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(a, cgt::kFwd);
}

// The row pass, with several chunks the sums of its parts, then the column
// pass and the sum of its dphi parts, on one stream; returns the first
// non-zero cudaGetLastError(). `row` holds nz + 1 parts of [B, N], nz =
// ceil(Cg / chunk): the row term's (part 0 their sum), then the exponent
// bias that the row pass at C <= 64 writes for its column pass;
// dtheta_parts and dphi_parts are read only when nz > 1.
int cgt_attention_bwd(const void* theta, const void* phi, const void* g,
                      const void* dout, const void* mx, const void* den,
                      void* dtheta, void* row, void* dphi, void* dg,
                      void* dtheta_parts, void* dphi_parts, int B, int N,
                      int M, int C, int Cg, int chunk, int is_bf16,
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
  a.dtheta_parts = static_cast<float*>(dtheta_parts);
  a.dphi_parts = static_cast<float*>(dphi_parts);
  a.B = B;
  a.N = N;
  a.M = M;
  a.C = C;
  a.Cg = Cg;
  a.chunk = chunk;
  a.bf16 = is_bf16 != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  int err = launch(a, cgt::kRowsPass);
  if (err != 0) return err;
  const int nz = a.nz();
  if (nz > 1) {
    const long nc = static_cast<long>(B) * N * C;
    err = a.bf16 ? sum_parts(a.dtheta_parts, static_cast<bf16*>(dtheta), nc,
                             nz, a.stream)
                 : sum_parts(a.dtheta_parts, static_cast<float*>(dtheta), nc,
                             nz, a.stream);
    if (err != 0) return err;
    err = sum_parts(a.row, a.row, static_cast<long>(B) * N, nz, a.stream);
    if (err != 0) return err;
  }
  err = launch(a, cgt::kColsPass);
  if (err != 0 || nz == 1) return err;
  return sum_parts(a.dphi_parts, a.dphi, static_cast<long>(B) * M * C, nz,
                   a.stream);
}

const char* cgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // CGT_CP || CGT_WIDE
