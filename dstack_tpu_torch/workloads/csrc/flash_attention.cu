// Flash attention forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces four TPU kernels of dstack_tpu/workloads/flash_attention.py:
//   flash_fwd_sm90_kernel (bf16), flash_fwd_kernel (f32)
//                           <- `_fwd_kernel` (:219, body `_streaming_attend` :170)
//   flash_block_fwd_sm90_kernel (bf16), flash_block_fwd_kernel (f32)
//                           <- `_block_fwd_kernel` (:455, the ring step)
//   flash_bwd_dq_kernel     <- `_bwd_dq_kernel` (:256)
//   flash_bwd_dkv_kernel    <- `_bwd_dkv_kernel` (:294)
// Same functions on (BH, S, HD) tensors, GQA already expanded by the
// caller: the forward writes normalised O in the input dtype and
// lse = m + log(l) in f32, laid out (BH, S) (the TPU's (BH, 1, S) was only
// its tiling rule); the backward recomputes P = exp(Q K^T * scale - lse)
// tile by tile, dS = P * (dO V^T - delta) * scale with delta = rowsum(dO*O)
// computed by the caller, dQ = dS K, dK = dS^T Q, dV = P^T dO. Masked
// logits are NEG_INF (-1e30), never -inf; the running max is floored at
// NEG_INF/2 and the denominator at 1e-30, as in the reference. Causal
// masking is row >= col. Any S is taken: rows and columns >= S of a ragged
// last tile are zero-filled on load and masked out of every sum.
//
// What bounds them on this card: operations. At the smol-1b training shape
// (BH 128, S 2048, HD 128, causal, bf16) the forward does ~137 GFLOP on
// ~0.27 GB, some 500 flop per byte, above the ~295 the H100 needs before
// its tensor cores rather than HBM are the limit; the backward kernels do
// ~206 and ~275 GFLOP on ~0.34-0.40 GB. At the ring step of smol-1b-8k
// over 4 shards (BH 16, S 2048, HD 128, bf16) a full step is ~34 GFLOP on
// ~42 MB: bound by operations too. Every kernel keeps the (S, S) scores out
// of HBM; the TPU grid ran one cell per (b*h, q tile) with a head's whole
// K/V in VMEM, here a loop inside each CTA streams K/V tiles through shared
// memory and stops at the diagonal when causal, heaviest tiles first.
//
// The bf16 forward (flash_fwd_sm90_kernel, flash_block_fwd_sm90_kernel: one
// body, `sm90::fwd_body`, two epilogues) is built for what only Hopper
// offers, since at ~500 flop per byte the tensor cores' rate is the limit
// and only wgmma reaches it:
//   - one CTA per (b*h, 128-row q tile): a producer warpgroup whose one
//     thread issues TMA copies (Q once, then K and V tiles of 128 keys into
//     a 2-stage ring with full/empty mbarriers), and two consumer
//     warpgroups of 64 query rows each; setmaxnreg moves registers from the
//     producer (24) to the consumers (240);
//   - S = Q K^T is a wgmma m64n128k16 with both operands in shared memory,
//     K-major in the TMA's 128-byte (64 for HD 32) swizzle (an HD-128 row
//     is two 64-column boxes); O += P V is a wgmma with P in registers:
//     the S accumulator's layout is the A fragment's, so P is rounded to
//     bf16 and fed without a trip through shared memory; V is read as an
//     MN-major B through the transpose bit, with no transpose pass;
//   - the softmax runs on the accumulator in registers: the row max is
//     taken on the raw scores and scaled once (so m is exactly the
//     reference's max of s * scale, in natural-log units for lse and the
//     ring's m), P = exp2(s * scale * log2(e) - m * log2(e)), and the mask
//     is applied only on tiles that cross the diagonal or S;
//   - the tensor cores idle while a warpgroup runs its softmax, so each
//     warpgroup issues tile j's S = Q K^T together with tile j-1's P V,
//     runs tile j's softmax while the P V is in flight, and only then
//     rescales O and writes tile j's P into the A registers; the two
//     warpgroups take turns to issue (named barriers), so one's softmax
//     also runs under the other's products. ptxas serializes the wgmma
//     pipeline (its C7513/C7514 notes) when it cannot keep an in-flight
//     product's registers apart from the code around it: the first tile is
//     peeled off so the loop issues both products unconditionally, and P
//     stays f32 in the S registers until the P V that reads the A
//     registers has landed (a second bf16 P buffer copied into the first
//     was serialized);
//   - K/V tiles go in descending order (the masked tiles first), the ring
//     lets the next tile's copy run under this tile's products.
// BK = 128 halves the barrier round trips of BK = 64 and the registers
// hold it: O (64 f32 per thread at HD 128), S (64 f32) and P (32 packed).
// TMA zero-fills rows >= S of a tile; the mask and row-guarded stores do
// the rest, so any S is taken.
//
// The f32 forward keeps the portable body `fwd_body<HD, kBlock>`:
// wgmma has no f32 product (only TF32), and the f32 kernels exist to hold
// the algorithm exactly (plain FMA on the mma fragment layout). The
// backward kernels (mma.sync m16n8k16 for bf16, the same FMA for f32) run
// four warps per CTA of 16 rows each; the dK/dV kernel runs one CTA per
// (b*h, kv tile) and loops over q tiles from the tile holding row k0. P
// and dS are rounded to bf16 before their products for bf16 inputs, where
// the TPU kernel kept them in f32; the softmax statistics, the
// denominators and every accumulator stay f32.
//
// The ring step (the `kBlock` epilogue) writes O unnormalised, relative to
// the row's final max m, in f32 whatever the inputs' type; m (floored at
// NEG_INF/2 like the running max) and l = rowsum(exp(s - m)) (not floored)
// beside it, (BH, S) each, for the ring's merge. q and k/v shards have the
// same S (the ring's equal shards: the causal mask row >= col is the ring's
// diagonal block only then).
//
// Launch contract: the kernels allocate nothing, run on the caller's
// stream, and each C entry point returns cudaGetLastError() after launch.
// The bf16 forward builds its TMA descriptors on the host at each launch
// (the pointers change every call), through cuTensorMapEncodeTiled fetched
// from the driver by the runtime, so the library links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 227 * 1024;

// Shared-memory rows are padded so the fragment loads of the 8 row groups
// of a warp fall into distinct banks (16 bytes keeps 16-byte row starts).
template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int kElems = 4;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int kElems = 8;
};

struct Args {
  const void* q;      // (BH, S, HD)
  const void* k;      // (BH, S, HD)
  const void* v;      // (BH, S, HD)
  const void* o;      // (BH, S, HD)   forward output
  const void* dout;   // (BH, S, HD)   dO
  float* lse;         // (BH, S)
  float* m_out;       // (BH, S)       ring step: row max
  float* l_out;       // (BH, S)       ring step: row sum
  const float* delta; // (BH, S)
  void* dq;           // (BH, S, HD)
  void* dk;           // (BH, S, HD)
  void* dv;           // (BH, S, HD)
  int S;
  int causal;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t(__bfloat16_as_ushort(hi)) << 16) | uint32_t(__bfloat16_as_ushort(lo));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  p[0] = x;
  p[1] = y;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[nt][e] accumulates the warp's 16 x (NT*8) product A(16 x K) B(K x NT*8)
// in the mma C-fragment layout: lane (g = lane/4, t = lane%4) holds rows g
// (e = 0, 1) and g + 8 (e = 2, 3), columns nt*8 + 2t + (e & 1).
// A is row-major at `a` (row stride lda). B(k, n) is b[n*ldb + k] when kNK
// (the operand stored n-major, as K is for Q K^T), else b[k*ldb + n].
template <int NT, int K, bool kNK>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ld32(a + g * lda + k0 + 2 * t);
    const uint32_t a1 = ld32(a + (g + 8) * lda + k0 + 2 * t);
    const uint32_t a2 = ld32(a + g * lda + k0 + 2 * t + 8);
    const uint32_t a3 = ld32(a + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b0, b1;
      if (kNK) {
        b0 = ld32(b + n * ldb + k0 + 2 * t);
        b1 = ld32(b + n * ldb + k0 + 2 * t + 8);
      } else {
        b0 = pack(b[(k0 + 2 * t) * ldb + n], b[(k0 + 2 * t + 1) * ldb + n]);
        b1 = pack(b[(k0 + 2 * t + 8) * ldb + n], b[(k0 + 2 * t + 9) * ldb + n]);
      }
      mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// The same product for f32 operands, in plain FMA on the same layout.
template <int NT, int K, bool kNK>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* a, int lda,
                                          const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float lo = a[g * lda + k];
    const float hi = a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float b0 = kNK ? b[n * ldb + k] : b[k * ldb + n];
      const float b1 = kNK ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
      acc[nt][0] = fmaf(lo, b0, acc[nt][0]);
      acc[nt][1] = fmaf(lo, b1, acc[nt][1]);
      acc[nt][2] = fmaf(hi, b0, acc[nt][2]);
      acc[nt][3] = fmaf(hi, b1, acc[nt][3]);
    }
  }
}

// Rows r0 .. r0+rows-1 of one head's (S, HD) matrix into shared memory
// (row stride LD), 16 bytes per thread and load; rows >= S are zeros.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int rows, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * HD + ch * kVec);
    *reinterpret_cast<uint4*>(dst + r * LD + ch * kVec) = val;
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a warp's 16-row fragment (rows row0 + g, row0 + g + 8 of a matrix
// with row stride ld) as T, skipping rows >= S.
template <typename T, int NT>
__device__ __forceinline__ void store_frag(T* base, int ld, int row0, int S,
                                           const float (&acc)[NT][4], float s0, float s1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row0 + g < S) store2(base + size_t(row0 + g) * ld + col, acc[nt][0] * s0, acc[nt][1] * s0);
    if (row0 + g + 8 < S)
      store2(base + size_t(row0 + g + 8) * ld + col, acc[nt][2] * s1, acc[nt][3] * s1);
  }
}

// ------------------------------------------------------------------ forward

template <int HD>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LD = HD + Pad<float>::kElems;
  static constexpr int LDP = BK + Pad<float>::kElems;
  static constexpr size_t smem =
      sizeof(float) * (size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LDP);
};

// The f32 streaming-softmax loop shared by the forward and the ring step;
// kBlock picks the epilogue (see the header). bf16 runs `sm90::fwd_body`.
template <int HD, bool kBlock>
__device__ __forceinline__ void fwd_body(const Args& p) {
  using C = FwdCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + C::BQ * C::LD;
  float* vs = ks + C::BK * C::LD;
  float* ps = vs + C::BK * C::LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;  // heaviest tiles first
  const size_t head = size_t(blockIdx.y) * p.S;
  const float* q = static_cast<const float*>(p.q) + head * HD;
  const float* k = static_cast<const float*>(p.k) + head * HD;
  const float* v = static_cast<const float*>(p.v) + head * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float* pw = ps + warp * 16 * C::LDP;

  load_tile<float, HD, C::LD>(qs, q, q0, C::BQ, p.S);
  float m[2] = {kNegInf * 0.5f, kNegInf * 0.5f};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4] = {};
  const int n_all = (p.S + C::BK - 1) / C::BK;
  const int n_kt = p.causal ? min(n_all, (q0 + C::BQ + C::BK - 1) / C::BK) : n_all;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * C::BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_tile<float, HD, C::LD>(ks, k, k0, C::BK, p.S);
    load_tile<float, HD, C::LD>(vs, v, k0, C::BK, p.S);
    __syncthreads();

    float s[C::BK / 8][4] = {};
    warp_gemm<C::BK / 8, HD, true>(s, qs + warp * 16 * C::LD, C::LD, ks, C::LD);
    float bm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < C::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * p.scale;
        if (col >= p.S || (p.causal && row < col)) x = kNegInf;
        s[nt][e] = x;
        bm[e >> 1] = fmaxf(bm[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], fmaxf(quad_max(bm[r]), kNegInf * 0.5f));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < C::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[nt][e] - m[e >> 1]);  // masked: exp(-5e29) == 0
        s[nt][e] = pv;
        rs[e >> 1] += pv;
      }
      store2(pw + g * C::LDP + nt * 8 + 2 * t, s[nt][0], s[nt][1]);
      store2(pw + (g + 8) * C::LDP + nt * 8 + 2 * t, s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    __syncwarp();
    warp_gemm<HD / 8, C::BK, false>(acc, pw, C::LDP, vs, C::LD);
  }

  if constexpr (kBlock) {
    store_frag<float, HD / 8>(static_cast<float*>(const_cast<void*>(p.o)) + head * HD, HD,
                              q0 + warp * 16, p.S, acc, 1.f, 1.f);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row0 + 8 * r < p.S) {
          p.m_out[head + row0 + 8 * r] = m[r];
          p.l_out[head + row0 + 8 * r] = l[r];
        }
      }
    }
  } else {
    l[0] = fmaxf(l[0], 1e-30f);
    l[1] = fmaxf(l[1], 1e-30f);
    store_frag<float, HD / 8>(static_cast<float*>(const_cast<void*>(p.o)) + head * HD, HD,
                              q0 + warp * 16, p.S, acc, 1.f / l[0], 1.f / l[1]);
    if (t == 0) {
      if (row0 < p.S) p.lse[head + row0] = m[0] + logf(l[0]);
      if (row0 + 8 < p.S) p.lse[head + row0 + 8] = m[1] + logf(l[1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args p) {
  fwd_body<HD, false>(p);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_block_fwd_kernel(Args p) {
  fwd_body<HD, true>(p);
}

// ------------------------------------------------- bf16 forward for Hopper

namespace sm90 {

constexpr int kBQ = 128;  // two consumer warpgroups of 64 query rows
constexpr int kBK = 128;  // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup, then two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// setmaxnreg moves registers inside the CTA's allocation: the consumers'
// 240 fit only if the kernel was allocated 65536 / 384 = 168 per thread.
constexpr int kLaunchRegs = 168;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  // A tile is kChunks column blocks of kChunkCols, each (rows, kChunkCols)
  // with kRowBytes-byte rows in the TMA's swizzle (the box's inner extent
  // is capped at the swizzle width).
  static constexpr int kChunkCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = kChunkCols * 2;
  static constexpr int kChunks = HD / kChunkCols;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: 128B or 64B swizzle
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr uint32_t kTileBytes = kBK * HD * 2;  // also the Q tile's
  static constexpr uint32_t kQ = 0, kK = kTileBytes, kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  // 1 + 4 * kStages mbarriers, and slack to align the base to 1024 bytes.
  static constexpr size_t smem = kBar + 8 * (1 + 4 * kStages) + 1024;
};

struct Maps {
  CUtensorMap q, k, v;  // each (BH, S, HD) as 3-d, boxes (1, 128, kChunkCols)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Until the phase of `parity` has completed (a fresh barrier counts its
// phase 1 as completed, so producers start with parity 1 on empties).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (col, row, head) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory operand descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers over the two consumer warpgroups (0 is __syncthreads).
constexpr int kTurnBar = 1;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Pins the registers of an accumulator at this point of the program, so
// the compiler moves no read or write of them across an async wgmma's
// issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The products. The accumulator d[4 * j + e] of a thread (warp w of the
// warpgroup, lane = 4 g + c) is row 16 w + g + 8 (e >> 1), column
// 8 j + 2 c + (e & 1): the mma.sync C layout repeated over the width.
// S (64 x 128) += A (64 x 16) B^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x N) += P (64 x 16, bf16 pairs in the A fragment layout) V, V an
// MN-major B in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// S (64 x kBK) = Q K^T over HD, the first k16 step overwriting S. Q and K
// are K-major: within a swizzled row a k16 step moves the start by 32
// bytes; past kChunkCols it moves to the next column block.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_tile, uint32_t k_tile) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t blk = (kk * 16) / C::kChunkCols, off = (kk * 16) % C::kChunkCols * 2;
    wgmma_ss_n128(
        sc, smem_desc(q_tile + blk * kBQ * C::kRowBytes + off, 16, 8 * C::kRowBytes, C::kLayout),
        smem_desc(k_tile + blk * kBK * C::kRowBytes + off, 16, 8 * C::kRowBytes, C::kLayout),
        kk > 0);
  }
}

// O (64 x HD) += P V over kBK keys. V is MN-major: a k16 step is 16 rows
// further; the leading offset steps to the next column block.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_tile) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o, pa[kk],
             smem_desc(v_tile + kk * 16 * C::kRowBytes, kBK * C::kRowBytes, 8 * C::kRowBytes,
                       C::kLayout));
}

// What the softmax of a thread needs to know of its rows.
struct Rows {
  int first;  // the warpgroup's first row
  int row0;   // this thread's rows: row0, row0 + 8
  int c4;     // lane % 4: columns 2 c4, 2 c4 + 1 of each 8
  int S, causal;
  float scale;
};

// The online softmax of one S tile (keys k0 ...) in registers: masks it
// where the tile reaches past S, or past the warpgroup's first row when
// causal; updates m and l; leaves P (f32) in place of S and returns the
// factor alpha that takes O to the new max.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Rows& w, int k0) {
  if (k0 + kBK > w.S || (w.causal && k0 + kBK - 1 > w.first)) {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int col = k0 + (j / 4) * 8 + 2 * w.c4 + (j & 1);
      const int row = w.row0 + ((j >> 1) & 1) * 8;
      if (col >= w.S || (w.causal && col > row)) sc[j] = -INFINITY;
    }
  }
  // The row max on the raw scores: max(s) * scale rounds to the same value
  // as max(s * scale), the reference's m.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 64; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], fmaxf(quad_max(mx[r]) * w.scale, kNegInf * 0.5f));
    alpha[r] = ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    mc[r] = m_new * kLog2e;
  }
  // P = exp(s * scale - m) = exp2(s * scale * log2(e) - m * log2(e));
  // masked: exp2(-inf) = 0.
  const float scale_log2 = w.scale * kLog2e;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    sc[j] = ex2(fmaf(sc[j], scale_log2, -mc[(j >> 1) & 1]));
    rs[(j >> 1) & 1] += sc[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
}

// P rounded to bf16 as the A fragments of P V: pairs of the accumulator
// layout are the A layout's, k16 step kk holding columns 16 kk ..., i.e.
// accumulator entries 8 kk .. 8 kk + 7.
__device__ __forceinline__ void to_a_frag(const float (&sc)[64], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) pa[kk][h] = pack_bf16(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
}

// The forward's streaming loop for bf16; kBlock picks the ring step's
// epilogue (see the header). Grid (ceil(S / 128), BH), kThreads threads.
template <int HD, bool kBlock>
__device__ __forceinline__ void fwd_body(const Maps& maps, const Args& p) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  const uint32_t full_q = base + C::kBar;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int head = blockIdx.y;
  const int n_all = (p.S + kBK - 1) / kBK;
  const int n_kt = p.causal ? min(n_all, (q0 + kBQ + kBK - 1) / kBK) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full. Tile i of the loop (keys
    // (n_kt - 1 - i) * kBK ...) goes to stage i % kStages.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(base + C::kQ + c * kBQ * C::kRowBytes, &maps.q, full_q, c * C::kChunkCols, q0,
                 head);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (n_kt - 1 - i) * kBK;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(base + C::kK + s * C::kTileBytes + c * kBK * C::kRowBytes, &maps.k,
                   full_k + 8 * s, c * C::kChunkCols, k0, head);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(base + C::kV + s * C::kTileBytes + c * kBK * C::kRowBytes, &maps.v,
                   full_v + 8 * s, c * C::kChunkCols, k0, head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows q0 + 64 cw ...
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, g = lane / 4, c4 = lane % 4;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_tile = base + C::kQ + cw * 64 * C::kRowBytes;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf * 0.5f, kNegInf * 0.5f};
    float l[2] = {0.f, 0.f};
    uint32_t pa[kBK / 16][4];  // the previous tile's P, read by its P V in flight
    // Turns: a warpgroup issues its products between sync(own barrier)
    // and arrive(the other's), so one warpgroup's softmax runs under the
    // other's products. The second warpgroup lets the first go first and
    // skips its last arrive, so every barrier phase completes.
    const int own_turn = kTurnBar + cw, other_turn = kTurnBar + 1 - cw;
    if (cw == 1) named_arrive(other_turn);
    mbar_wait(full_q, 0);
    const Rows rows{q0 + cw * 64, row0, c4, p.S, p.causal, p.scale};

    // Tile 0 (keys (n_kt - 1) * kBK ...): S alone.
    {
      float sc[64];  // written whole by the first k16 step
      float alpha[2];
      mbar_wait(full_k, 0);
      named_sync(own_turn);
      wgmma_fence();
      issue_qk<HD>(sc, q_tile, base + C::kK);
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k);
      softmax_tile(sc, m, l, alpha, rows, (n_kt - 1) * kBK);
      to_a_frag(sc, pa);
    }
    // Tile i: its S = Q K^T and tile i-1's O += P V in flight together;
    // the softmax of tile i runs while the P V does, and P goes into the A
    // registers only once the P V that reads them has landed.
    for (int i = 1; i < n_kt; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      float sc[64];
      float alpha[2];
      mbar_wait(full_k + 8 * s, (i / kStages) & 1);
      mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
      fence_regs(pa);
      fence_regs(o);
      named_sync(own_turn);
      wgmma_fence();
      issue_qk<HD>(sc, q_tile, base + C::kK + s * C::kTileBytes);
      wgmma_commit();
      issue_pv<HD>(o, pa, base + C::kV + sp * C::kTileBytes);  // the previous tile's stage
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait<1>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      softmax_tile(sc, m, l, alpha, rows, (n_kt - 1 - i) * kBK);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      // O to this tile's max, then this tile's P.
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      to_a_frag(sc, pa);
    }
    // The last tile's P V.
    const int sl = (n_kt - 1) % kStages;
    mbar_wait(full_v + 8 * sl, ((n_kt - 1) / kStages) & 1);
    fence_regs(o);
    fence_regs(pa);
    named_sync(own_turn);
    wgmma_fence();
    issue_pv<HD>(o, pa, base + C::kV + sl * C::kTileBytes);
    wgmma_commit();
    if (cw == 0) named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);

    const size_t hrow = size_t(head) * p.S;
    if constexpr (kBlock) {
      float* out = static_cast<float*>(const_cast<void*>(p.o)) + hrow * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + 2 * c4;
        if (row0 < p.S)
          *reinterpret_cast<float2*>(out + size_t(row0) * HD + col) =
              make_float2(o[4 * j], o[4 * j + 1]);
        if (row0 + 8 < p.S)
          *reinterpret_cast<float2*>(out + size_t(row0 + 8) * HD + col) =
              make_float2(o[4 * j + 2], o[4 * j + 3]);
      }
      if (c4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (row0 + 8 * r < p.S) {
            p.m_out[hrow + row0 + 8 * r] = m[r];
            p.l_out[hrow + row0 + 8 * r] = l[r];
          }
        }
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(const_cast<void*>(p.o)) + hrow * HD;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = fmaxf(l[r], 1e-30f);
        inv[r] = 1.f / l[r];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + 2 * c4;
        if (row0 < p.S)
          store2(out + size_t(row0) * HD + col, o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
        if (row0 + 8 < p.S)
          store2(out + size_t(row0 + 8) * HD + col, o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
      }
      if (c4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + 8 * r < p.S) p.lse[hrow + row0 + 8 * r] = m[r] + logf(l[r]);
      }
    }
  }
}

}  // namespace sm90

template <int HD>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ sm90::Maps maps, Args p) {
  sm90::fwd_body<HD, false>(maps, p);
}

template <int HD>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_block_fwd_sm90_kernel(const __grid_constant__ sm90::Maps maps, Args p) {
  sm90::fwd_body<HD, true>(maps, p);
}

// --------------------------------------------------------------- dQ kernel

template <typename T, int HD>
struct DqCfg {
  static constexpr int BQ = 64, BK = 32;
  static constexpr int LD = HD + Pad<T>::kElems;
  static constexpr int LDS = BK + Pad<T>::kElems;
  static constexpr size_t smem =
      sizeof(T) * (2 * size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LDS);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args p) {
  using C = DqCfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + C::BQ * C::LD;
  T* ks = dos + C::BQ * C::LD;
  T* vs = ks + C::BK * C::LD;
  T* dss = vs + C::BK * C::LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const size_t head = size_t(blockIdx.y) * p.S;
  const T* q = static_cast<const T*>(p.q) + head * HD;
  const T* k = static_cast<const T*>(p.k) + head * HD;
  const T* v = static_cast<const T*>(p.v) + head * HD;
  const T* dout = static_cast<const T*>(p.dout) + head * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  T* dw = dss + warp * 16 * C::LDS;

  load_tile<T, HD, C::LD>(qs, q, q0, C::BQ, p.S);
  load_tile<T, HD, C::LD>(dos, dout, q0, C::BQ, p.S);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse[r] = row < p.S ? p.lse[head + row] : 0.f;
    delta[r] = row < p.S ? p.delta[head + row] : 0.f;
  }
  float acc[HD / 8][4] = {};
  const int n_all = (p.S + C::BK - 1) / C::BK;
  const int n_kt = p.causal ? min(n_all, (q0 + C::BQ + C::BK - 1) / C::BK) : n_all;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * C::BK;
    __syncthreads();
    load_tile<T, HD, C::LD>(ks, k, k0, C::BK, p.S);
    load_tile<T, HD, C::LD>(vs, v, k0, C::BK, p.S);
    __syncthreads();

    float s[C::BK / 8][4] = {};
    float dp[C::BK / 8][4] = {};
    warp_gemm<C::BK / 8, HD, true>(s, qs + warp * 16 * C::LD, C::LD, ks, C::LD);
    warp_gemm<C::BK / 8, HD, true>(dp, dos + warp * 16 * C::LD, C::LD, vs, C::LD);
#pragma unroll
    for (int nt = 0; nt < C::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * p.scale;
        if (col >= p.S || (p.causal && row < col)) x = kNegInf;
        const float pv = expf(x - lse[e >> 1]);
        dp[nt][e] = pv * (dp[nt][e] - delta[e >> 1]) * p.scale;
      }
      store2(dw + g * C::LDS + nt * 8 + 2 * t, dp[nt][0], dp[nt][1]);
      store2(dw + (g + 8) * C::LDS + nt * 8 + 2 * t, dp[nt][2], dp[nt][3]);
    }
    __syncwarp();
    warp_gemm<HD / 8, C::BK, false>(acc, dw, C::LDS, ks, C::LD);
  }
  store_frag<T, HD / 8>(static_cast<T*>(p.dq) + head * HD, HD, q0 + warp * 16, p.S, acc, 1.f, 1.f);
}

// ------------------------------------------------------------ dK/dV kernel

template <typename T, int HD>
struct DkvCfg {
  static constexpr int BKV = 64, BQ = 32;
  static constexpr int LD = HD + Pad<T>::kElems;
  static constexpr int LDP = BQ + Pad<T>::kElems;
  static constexpr size_t smem = sizeof(T) * (2 * size_t(BKV) * LD + 2 * size_t(BQ) * LD +
                                              size_t(BKV) * LDP) +
                                 2 * BQ * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args p) {
  using C = DkvCfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + C::BKV * C::LD;
  T* qs = vs + C::BKV * C::LD;
  T* dos = qs + C::BQ * C::LD;
  T* pts = dos + C::BQ * C::LD;
  float* lse_s = reinterpret_cast<float*>(pts + C::BKV * C::LDP);
  float* delta_s = lse_s + C::BQ;

  const int k0 = blockIdx.x * C::BKV;  // causal: the early tiles see most rows
  const size_t head = size_t(blockIdx.y) * p.S;
  const T* q = static_cast<const T*>(p.q) + head * HD;
  const T* k = static_cast<const T*>(p.k) + head * HD;
  const T* v = static_cast<const T*>(p.v) + head * HD;
  const T* dout = static_cast<const T*>(p.dout) + head * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = k0 + warp * 16 + g;  // this lane's keys: row0, row0 + 8
  T* pw = pts + warp * 16 * C::LDP;

  load_tile<T, HD, C::LD>(ks, k, k0, C::BKV, p.S);
  load_tile<T, HD, C::LD>(vs, v, k0, C::BKV, p.S);
  float dk[HD / 8][4] = {};
  float dv[HD / 8][4] = {};
  const int n_qt = (p.S + C::BQ - 1) / C::BQ;
  // Causal: q tiles whose last row is before k0 see none of this kv tile;
  // the first useful one is the tile holding row k0.
  const int i0 = p.causal ? k0 / C::BQ : 0;

  for (int i = i0; i < n_qt; ++i) {
    const int q0 = i * C::BQ;
    __syncthreads();
    load_tile<T, HD, C::LD>(qs, q, q0, C::BQ, p.S);
    load_tile<T, HD, C::LD>(dos, dout, q0, C::BQ, p.S);
    load_vec(lse_s, p.lse + head, q0, C::BQ, p.S);
    load_vec(delta_s, p.delta + head, q0, C::BQ, p.S);
    __syncthreads();

    // Transposed scores: rows are keys, columns queries.
    float st[C::BQ / 8][4] = {};
    float dpt[C::BQ / 8][4] = {};
    warp_gemm<C::BQ / 8, HD, true>(st, ks + warp * 16 * C::LD, C::LD, qs, C::LD);
    warp_gemm<C::BQ / 8, HD, true>(dpt, vs + warp * 16 * C::LD, C::LD, dos, C::LD);
#pragma unroll
    for (int nt = 0; nt < C::BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const int col = q0 + c;
        const int row = row0 + (e >> 1) * 8;
        float x = st[nt][e] * p.scale;
        if (col >= p.S || (p.causal && col < row)) x = kNegInf;
        const float pv = expf(x - lse_s[c]);
        st[nt][e] = pv;
        dpt[nt][e] = pv * (dpt[nt][e] - delta_s[c]) * p.scale;
      }
      store2(pw + g * C::LDP + nt * 8 + 2 * t, st[nt][0], st[nt][1]);
      store2(pw + (g + 8) * C::LDP + nt * 8 + 2 * t, st[nt][2], st[nt][3]);
    }
    __syncwarp();
    warp_gemm<HD / 8, C::BQ, false>(dv, pw, C::LDP, dos, C::LD);
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < C::BQ / 8; ++nt) {
      store2(pw + g * C::LDP + nt * 8 + 2 * t, dpt[nt][0], dpt[nt][1]);
      store2(pw + (g + 8) * C::LDP + nt * 8 + 2 * t, dpt[nt][2], dpt[nt][3]);
    }
    __syncwarp();
    warp_gemm<HD / 8, C::BQ, false>(dk, pw, C::LDP, qs, C::LD);
  }
  store_frag<T, HD / 8>(static_cast<T*>(p.dk) + head * HD, HD, k0 + warp * 16, p.S, dk, 1.f, 1.f);
  store_frag<T, HD / 8>(static_cast<T*>(p.dv) + head * HD, HD, k0 + warp * 16, p.S, dv, 1.f, 1.f);
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

namespace sm90 {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (null if none).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// (BH, S, HD) bf16 as a 3-d map (HD innermost), boxes of 128 rows by one
// column block; rows past S read as zeros.
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH, int S) {
  using C = Cfg<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(HD), cuuint64_t(S), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(HD) * 2, cuuint64_t(S) * HD * 2};
  const cuuint32_t box[3] = {cuuint32_t(C::kChunkCols), cuuint32_t(kBK), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, C::kSwizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The register split of setmaxnreg holds only if ptxas gave the kernel
// kLaunchRegs per thread; a build that did not is refused here rather than
// left to wait for registers that never come.
template <typename Kernel>
cudaError_t check_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  return attr.numRegs >= kLaunchRegs ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

template <int HD, bool kBlock>
cudaError_t launch(int BH, const Args& a, cudaStream_t stream) {
  auto kernel = kBlock ? flash_block_fwd_sm90_kernel<HD> : flash_fwd_sm90_kernel<HD>;
  static const cudaError_t regs = check_regs(kernel);
  if (regs != cudaSuccess) return regs;
  Maps maps;
  cudaError_t e;
  if ((e = make_map<HD>(&maps.q, a.q, BH, a.S)) != cudaSuccess) return e;
  if ((e = make_map<HD>(&maps.k, a.k, BH, a.S)) != cudaSuccess) return e;
  if ((e = make_map<HD>(&maps.v, a.v, BH, a.S)) != cudaSuccess) return e;
  const size_t smem = Cfg<HD>::smem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.S + kBQ - 1) / kBQ, BH), kThreads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace sm90

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kBlockFwd = 3 };

template <typename T, int HD>
cudaError_t dispatch(Which w, int BH, const Args& a, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (w == kFwd) return sm90::launch<HD, false>(BH, a, st);
    if (w == kBlockFwd) return sm90::launch<HD, true>(BH, a, st);
  } else if (w == kFwd || w == kBlockFwd) {
    using C = FwdCfg<HD>;
    const dim3 grid((a.S + C::BQ - 1) / C::BQ, BH);
    if (w == kBlockFwd) return launch(flash_block_fwd_kernel<HD>, C::smem, grid, a, st);
    return launch(flash_fwd_kernel<HD>, C::smem, grid, a, st);
  }
  if (w == kDq) {
    using C = DqCfg<T, HD>;
    return launch(flash_bwd_dq_kernel<T, HD>, C::smem, dim3((a.S + C::BQ - 1) / C::BQ, BH), a, st);
  }
  using C = DkvCfg<T, HD>;
  return launch(flash_bwd_dkv_kernel<T, HD>, C::smem, dim3((a.S + C::BKV - 1) / C::BKV, BH), a, st);
}

int run(Which w, int BH, int HD, int dtype, const Args& a, void* stream) {
  if (BH <= 0 || BH > 65535 || a.S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (HD == 32) return dispatch<float, 32>(w, BH, a, st);
    if (HD == 64) return dispatch<float, 64>(w, BH, a, st);
    if (HD == 128) return dispatch<float, 128>(w, BH, a, st);
  } else if (dtype == 1) {
    if (HD == 32) return dispatch<__nv_bfloat16, 32>(w, BH, a, st);
    if (HD == 64) return dispatch<__nv_bfloat16, 64>(w, BH, a, st);
    if (HD == 128) return dispatch<__nv_bfloat16, 128>(w, BH, a, st);
  }
  return cudaErrorInvalidValue;
}

Args make_args(int S, int causal, float scale) {
  Args a = {};
  a.S = S;
  a.causal = causal;
  a.scale = scale;  // hd ** -0.5 rounded to f32 by the caller, as the reference
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 = launched).
int dstack_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                     int S, int HD, float scale, int causal, int dtype, void* stream) {
  Args a = make_args(S, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  return run(kFwd, BH, HD, dtype, a, stream);
}

// The ring step: o (BH, S, HD) f32 unnormalised, m and l (BH, S) f32.
int dstack_flash_block_fwd(const void* q, const void* k, const void* v, float* o, float* m,
                           float* l, int BH, int S, int HD, float scale, int causal, int dtype,
                           void* stream) {
  Args a = make_args(S, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.m_out = m;
  a.l_out = l;
  return run(kBlockFwd, BH, HD, dtype, a, stream);
}

int dstack_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, int BH, int S, int HD,
                        float scale, int causal, int dtype, void* stream) {
  Args a = make_args(S, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.dq = dq;
  return run(kDq, BH, HD, dtype, a, stream);
}

int dstack_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                         int HD, float scale, int causal, int dtype, void* stream) {
  Args a = make_args(S, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, BH, HD, dtype, a, stream);
}

}  // extern "C"
