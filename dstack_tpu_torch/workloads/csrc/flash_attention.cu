// Flash attention forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces four TPU kernels of dstack_tpu/workloads/flash_attention.py:
//   flash_fwd_kernel        <- `_fwd_kernel` (:219, body `_streaming_attend` :170)
//   flash_block_fwd_kernel  <- `_block_fwd_kernel` (:455, the ring step)
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
// its tensor cores rather than HBM are the limit. The design keeps the
// (S, S) score matrix out of HBM and feeds the tensor cores:
//   - the TPU grid ran one cell per (b*h, q tile) with a head's whole K/V in
//     VMEM; here the forward and dQ kernels run one CTA per (b*h, q tile)
//     and stream K/V tiles through shared memory in a loop that stops at
//     the diagonal when causal; the dK/dV kernel runs one CTA per
//     (b*h, kv tile) and loops over q tiles from the first one that holds
//     a row >= the tile's first key (the tile of row k0, with q and kv
//     tiles of different sizes);
//   - four warps per CTA, each owning 16 rows; the products run on the
//     tensor cores as mma.sync m16n8k16 bf16 -> f32 for bf16 inputs, and
//     as plain f32 FMA on the same fragment layout for f32 inputs (no
//     TF32);
//   - P (and dS in backward) pass through shared memory in the input
//     dtype before their product: for bf16 they are rounded to bf16 there,
//     where the TPU kernel kept them in f32. The softmax statistics, the
//     denominators and every accumulator stay f32.
// No wgmma, TMA or cp.async pipelining yet: a simple kernel that is right
// first. The causal grid launches the heaviest tiles first.
//
// The ring step (flash_block_fwd_kernel) is the forward's loop with the other
// epilogue of the reference (both call `_streaming_attend`): O stays
// unnormalised, relative to the row's final max m, and is written in f32
// whatever T is; m (floored at NEG_INF/2 like the running max) and
// l = rowsum(exp(s - m)) (not floored) are written beside it, (BH, S) each,
// for the ring's merge. q and k/v shards have the same S (the ring's equal
// shards: the causal mask row >= col is the ring's diagonal block only
// then). At the ring step of smol-1b-8k over 4 shards (BH 16, S 2048,
// HD 128, bf16) a full step is ~34 GFLOP on ~42 MB: bound by operations too.
//
// Launch contract: the kernels allocate nothing, run on the caller's
// stream, and each C entry point returns cudaGetLastError() after launch.

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

template <typename T, int HD>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LD = HD + Pad<T>::kElems;
  static constexpr int LDP = BK + Pad<T>::kElems;
  static constexpr size_t smem = sizeof(T) * (size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LDP);
};

// The streaming-softmax loop shared by the forward and the ring step; kBlock
// picks the epilogue (see the header).
template <typename T, int HD, bool kBlock>
__device__ __forceinline__ void fwd_body(const Args& p) {
  using C = FwdCfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + C::BQ * C::LD;
  T* vs = ks + C::BK * C::LD;
  T* ps = vs + C::BK * C::LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;  // heaviest tiles first
  const size_t head = size_t(blockIdx.y) * p.S;
  const T* q = static_cast<const T*>(p.q) + head * HD;
  const T* k = static_cast<const T*>(p.k) + head * HD;
  const T* v = static_cast<const T*>(p.v) + head * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  T* pw = ps + warp * 16 * C::LDP;

  load_tile<T, HD, C::LD>(qs, q, q0, C::BQ, p.S);
  float m[2] = {kNegInf * 0.5f, kNegInf * 0.5f};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4] = {};
  const int n_all = (p.S + C::BK - 1) / C::BK;
  const int n_kt = p.causal ? min(n_all, (q0 + C::BQ + C::BK - 1) / C::BK) : n_all;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * C::BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_tile<T, HD, C::LD>(ks, k, k0, C::BK, p.S);
    load_tile<T, HD, C::LD>(vs, v, k0, C::BK, p.S);
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
    store_frag<T, HD / 8>(static_cast<T*>(const_cast<void*>(p.o)) + head * HD, HD,
                          q0 + warp * 16, p.S, acc, 1.f / l[0], 1.f / l[1]);
    if (t == 0) {
      if (row0 < p.S) p.lse[head + row0] = m[0] + logf(l[0]);
      if (row0 + 8 < p.S) p.lse[head + row0 + 8] = m[1] + logf(l[1]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args p) {
  fwd_body<T, HD, false>(p);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_block_fwd_kernel(Args p) {
  fwd_body<T, HD, true>(p);
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

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kBlockFwd = 3 };

template <typename T, int HD>
cudaError_t dispatch(Which w, int BH, const Args& a, cudaStream_t st) {
  if (w == kFwd || w == kBlockFwd) {
    using C = FwdCfg<T, HD>;
    const dim3 grid((a.S + C::BQ - 1) / C::BQ, BH);
    if (w == kBlockFwd) return launch(flash_block_fwd_kernel<T, HD>, C::smem, grid, a, st);
    return launch(flash_fwd_kernel<T, HD>, C::smem, grid, a, st);
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
