// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (dstack_tpu/workloads/
// paged_attention.py:222, launched by `_ragged_attention_pallas`). Same
// function: query row (b, i) of head h attends the cache positions
// p < valid_len[b, i] of slot b, position p living at row p % bs of pool
// block tables[b, p / bs]; table entries outside [0, NB) (the pad sentinel
// NB) are never read and their positions are masked. Softmax state (m, l,
// acc) is f32, with the floors m >= NEG_INF/2 and l >= 1e-30 of the
// reference; probabilities are rounded to the storage dtype before the PV
// product, as the TPU kernel's `p.astype(v.dtype)`.
//
// What bounds it on this card: the bytes of K and V read from HBM, at
// both shapes the engine gives it. A decode step (S 1) does 2 flops per
// K/V byte per query head it carries, a 128-token chunk ~2 x 32 per byte
// for the 32 query vectors of a tile, both far below the ~295 flop/byte at
// which the H100's tensor cores become the limit. So the design keeps
// enough bytes in flight on every SM, and reads each K/V row once:
//   - one CTA per (tile of query rows, KV split, KV head g, slot b)
//     carries all n_rep = H / KV query heads of head g, so a row is read
//     once for its GQA group;
//   - split-KV (flash-decoding): the table-column axis, sequential on the
//     TPU, is cut into `splits` ranges of `kps` positions, each its own
//     CTA, so a batch of a few long slots still fills the 132 SMs. The
//     split count comes from shapes alone (`_split_plan` in
//     paged_attention.py), never from valid_len, which stays on the device:
//     the grid is fixed by shapes and a CUDA graph can capture the call. A
//     CTA whose split starts past its rows' longest valid length exits; the
//     others leave an f32 partial (o, m, l) that a second kernel merges
//     (M = max m_s, o = sum e^(m_s - M) o_s / max(sum e^(m_s - M) l_s,
//     1e-30), the merge of the ring's `_ring_attention_local`). With one
//     split the CTA writes the output itself;
//   - K and V tiles reach shared memory through a 3-stage cp.async ring
//     (16-byte copies, two tiles in flight while one is computed: 64 KB per
//     CTA at hd 128 bf16, 2 CTAs per SM, against the ~25 KB per SM that
//     HBM's latency asks for). Positions no row of the CTA may see
//     (sentinel blocks, past the split or the longest row) are zero-filled
//     by the copy instead of read, so NaN in unused blocks cannot reach the
//     output even through a 0 * NaN product inside a tensor-core sum;
//   - bf16 runs both products on the tensor cores (mma.sync m16n8k16,
//     bf16 -> f32): the CTA's query vectors, (row, head) pairs, are the M
//     axis, K and V come from XOR-swizzled shared memory through ldmatrix
//     (V transposed), and P goes from the S accumulators to the A operand
//     in registers, rounded to bf16. Decode fills 2 of the 16 rows, which
//     costs nothing at 2 flop per byte; the chunk path gets tensor cores.
//     The 4 warps split the query vectors into m-tiles of 16 and each
//     m-tile's keys into KG = 4 / m-tiles groups; the groups' states are
//     merged in shared memory at the end. f32 keeps CUDA-core FMAs on the
//     same fragment layout, with the same split, ring and merge.
//
// Launch contract: the kernels allocate nothing (the wrapper passes the
// split partials' workspace), run on the caller's stream, and the C entry
// point returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 64;    // (row, head) query vectors per CTA: 4 m-tiles
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kMaxTable = 1024;  // table entries one split spans, at most
constexpr int kKeyAlign = 64;    // keys per split: a multiple of every tile

struct Params {
  const void* q;        // (B, S, H, HD)
  const void* k;        // (NB, bs, KV, HD)
  const void* v;        // (NB, bs, KV, HD)
  const int* tables;    // (B, MB)
  const int* vlen;      // (B, S)
  void* out;            // (B, S, H, HD)
  float* ws;            // (splits, B*S*H, HD + 2): o, m, l of each split
  int B, S, H, KV, NB, bs, MB;
  int n_rep, rows_per_cta, row_tiles, splits, kps;
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype
  }
};

// Tile and shared-memory geometry of one (type, head dim).
template <typename T, int HD>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kRowBytes = HD * int(sizeof(T));
  static constexpr int R = kRowBytes / 16;  // 16-byte chunks per K/V row
  // Keys per ring stage: K and V of a stage hold at most 32 KB.
  static constexpr int TK = 16384 / kRowBytes < 64 ? 16384 / kRowBytes : 64;
  static constexpr int kHalf = TK * kRowBytes;  // K (then V) of one stage
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kRing = kStages * kStage;
  // The epilogue's per-warp (o, m, l) reuses the ring.
  static constexpr int kEpi = kWarps * 16 * (HD + 2) * 4;
  // f32 only: the CTA's query vectors (rows padded by 4 words) and each
  // warp's P tile, for the FMA products.
  static constexpr int LDQ = HD + 4;
  static constexpr int LDP = TK + 4;
  static constexpr int kQ = kF32 ? kMaxVec * LDQ * 4 : 0;
  static constexpr int kP = kF32 ? kWarps * 16 * LDP * 4 : 0;
  static constexpr int kSmem = kRing + kQ + kP;
  static_assert(kEpi <= kRing, "the epilogue reuses the ring");
  static_assert(kKeyAlign % TK == 0, "a split is whole tiles");
  static_assert(kSmem <= 227 * 1024, "shared memory");

  // XOR swizzle of 16-byte chunk c of row r: 8 consecutive rows' chunk c
  // land in 8 distinct 16-byte bank groups, so ldmatrix's 8-row reads and
  // the FMA readers' 8-key reads are free of bank conflicts.
  static __device__ __forceinline__ int swz(int r, int c) {
    if constexpr (R >= 8) {
      return c ^ (r & 7);
    } else {
      return c ^ ((r / (8 / R)) % R);
    }
  }
  static __device__ __forceinline__ int off(int r, int c) { return r * kRowBytes + swz(r, c) * 16; }
  // Element (key, d) of an f32 stage buffer.
  static __device__ __forceinline__ const float* elem(const unsigned char* buf, int key, int d) {
    return reinterpret_cast<const float*>(buf + off(key, d / 4) + (d & 3) * 4);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `src_bytes` 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragments below follow the mma.sync m16n8k16 C layout: lane (gr = lane/4,
// t = lane%4) holds rows gr (e = 0, 1) and gr + 8 (e = 2, 3) of a 16-row
// tile, columns 8 nt + 2t + (e & 1).

// S[16 x 8 NT] = Q K^T over the warp's keys key0 .. key0 + 8 NT - 1 of a
// stage, bf16 on the tensor cores: qa holds the warp's Q m-tile as A
// fragments, K comes through ldmatrix (two n-tiles per x4).
template <int HD, int NT>
__device__ __forceinline__ void qk_bf16(float (&s)[NT][4], const uint32_t (&qa)[HD / 16][4],
                                        const unsigned char* kst, int key0) {
  using C = Cfg<__nv_bfloat16, HD>;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const uint32_t base = smem_u32(kst);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int key = key0 + np * 16 + (mi >> 1) * 8 + r;
      uint32_t b[4];
      ldmatrix_x4(b, base + C::off(key, ks * 2 + (mi & 1)));
      mma_bf16(s[2 * np], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b[2], b[3]);
    }
  }
}

// O[16 x HD] += P V over the warp's keys: P from the S accumulators,
// rounded to bf16 as the A operand; V transposed by ldmatrix.
template <int HD, int NT>
__device__ __forceinline__ void pv_bf16(float (&o)[HD / 8][4], const float (&s)[NT][4],
                                        const unsigned char* vst, int key0) {
  using C = Cfg<__nv_bfloat16, HD>;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const uint32_t base = smem_u32(vst);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const int key = key0 + kk * 16 + (mi & 1) * 8 + r;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + C::off(key, np * 2 + (mi >> 1)));
      mma_bf16(o[2 * np], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

// The same two products in f32 FMAs: Q rows from shared memory (qm: the
// warp's m-tile, row stride LDQ), P through the warp's shared tile pw.
template <int HD, int NT>
__device__ __forceinline__ void qk_f32(float (&s)[NT][4], const float* qm,
                                       const unsigned char* kst, int key0) {
  using C = Cfg<float, HD>;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float lo = qm[gr * C::LDQ + d];
    const float hi = qm[(gr + 8) * C::LDQ + d];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = key0 + nt * 8 + 2 * t;
      const float k0 = *C::elem(kst, key, d);
      const float k1 = *C::elem(kst, key + 1, d);
      s[nt][0] = fmaf(lo, k0, s[nt][0]);
      s[nt][1] = fmaf(lo, k1, s[nt][1]);
      s[nt][2] = fmaf(hi, k0, s[nt][2]);
      s[nt][3] = fmaf(hi, k1, s[nt][3]);
    }
  }
}

template <int HD, int NT>
__device__ __forceinline__ void pv_f32(float (&o)[HD / 8][4], const float (&s)[NT][4], float* pw,
                                       const unsigned char* vst, int key0) {
  using C = Cfg<float, HD>;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    pw[gr * C::LDP + nt * 8 + 2 * t] = s[nt][0];
    pw[gr * C::LDP + nt * 8 + 2 * t + 1] = s[nt][1];
    pw[(gr + 8) * C::LDP + nt * 8 + 2 * t] = s[nt][2];
    pw[(gr + 8) * C::LDP + nt * 8 + 2 * t + 1] = s[nt][3];
  }
  __syncwarp();
  for (int kk = 0; kk < NT * 8; ++kk) {
    const float lo = pw[gr * C::LDP + kk];
    const float hi = pw[(gr + 8) * C::LDP + kk];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const float2 vv = *reinterpret_cast<const float2*>(C::elem(vst, key0 + kk, nt * 8 + 2 * t));
      o[nt][0] = fmaf(lo, vv.x, o[nt][0]);
      o[nt][1] = fmaf(lo, vv.y, o[nt][1]);
      o[nt][2] = fmaf(hi, vv.x, o[nt][2]);
      o[nt][3] = fmaf(hi, vv.y, o[nt][3]);
    }
  }
  __syncwarp();  // the next tile overwrites pw
}

// One CTA: query-row tile x KV split (blockIdx.x), KV head g (y), slot b
// (z). KG key groups: warp w takes m-tile w % (4 / KG) and key group
// w / (4 / KG), KW = TK / KG keys of every stage.
template <typename T, int HD, int KG>
__global__ void __launch_bounds__(kThreads, 2)
ragged_paged_attention_kernel(Params p) {
  using C = Cfg<T, HD>;
  using E = Elem<T>;
  constexpr int TK = C::TK, R = C::R;
  constexpr int MT = kWarps / KG;  // m-tiles per CTA
  constexpr int KW = TK / KG;      // keys per warp per stage
  constexpr int NT = KW / 8;
  static_assert(C::kF32 || NT % 2 == 0, "ldmatrix takes n-tiles in pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int tb[kMaxTable];
  __shared__ int s_maxlen;

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int tile = blockIdx.x / p.splits;
  const int split = blockIdx.x % p.splits;
  const int row0 = tile * p.rows_per_cta;
  const int nvec = min(p.rows_per_cta, p.S - row0) * p.n_rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int mt = warp % MT, kg = warp / MT;
  const int cols = p.MB * p.bs;

  // The CTA's longest row (warp 0) and the table entries its split spans
  // (the other warps; from shapes, so both loads are in flight at once).
  const int k_begin = split * p.kps;
  const int blk0 = k_begin / p.bs;
  if (warp == 0) {
    int m = 0;
    for (int r = lane; r < nvec / p.n_rep; r += 32) m = max(m, p.vlen[b * p.S + row0 + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) s_maxlen = min(m, cols);
  } else {
    const int n_span = (min(k_begin + p.kps, cols) - 1) / p.bs - blk0 + 1;
    for (int i = tid - 32; i < n_span; i += kThreads - 32) {
      const int e = p.tables[b * p.MB + blk0 + i];
      tb[i] = (e >= 0 && e < p.NB) ? e : -1;  // sentinel: never read, masked
    }
  }
  __syncthreads();
  const int k_end = min(k_begin + p.kps, s_maxlen);
  // An empty split leaves nothing: the merge reads split s of row (b, i)
  // only when s * kps < valid_len[b, i] <= this CTA's longest row.
  if (p.splits > 1 && k_begin >= k_end) return;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + TK - 1) / TK : 0;

  const T* q = static_cast<const T*>(p.q);
  auto q_at = [&](int vi, int d) -> const T* {
    const int i = row0 + vi / p.n_rep, h = g * p.n_rep + vi % p.n_rep;
    return q + ((size_t(b) * p.S + i) * p.H + h) * HD + d;
  };
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + C::kRing);
  float* pw = reinterpret_cast<float*>(smem + C::kRing + C::kQ) + warp * 16 * C::LDP;
  if constexpr (C::kF32) {
    for (int idx = tid; idx < MT * 16 * HD; idx += kThreads) {
      const int vi = idx / HD, d = idx % HD;
      qs[vi * C::LDQ + d] = vi < nvec ? E::to_f(*q_at(vi, d)) : 0.f;
    }  // read after the ring loop's first __syncthreads
  }

  const char* kbase = static_cast<const char*>(p.k);
  const char* vbase = static_cast<const char*>(p.v);
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int k0 = k_begin + j * TK;
      unsigned char* kst = ring + (j % kStages) * C::kStage;
      const uint32_t kdst = smem_u32(kst), vdst = kdst + C::kHalf;
#pragma unroll
      for (int u = 0; u < TK * R / kThreads; ++u) {
        const int c = u * kThreads + tid;
        const int key = c / R, ch = c % R;
        const int pos = k0 + key;
        const int blk = pos < k_end ? tb[pos / p.bs - blk0] : -1;
        size_t off = 0;
        if (blk >= 0) off = ((size_t(blk) * p.bs + pos % p.bs) * p.KV + g) * C::kRowBytes + ch * 16;
        const int n = blk >= 0 ? 16 : 0;  // zero-fill what no row may see
        cp_async16(kdst + C::off(key, ch), kbase + off, n);
        cp_async16(vdst + C::off(key, ch), vbase + off, n);
      }
    }
    cp_async_commit();  // one group per tile index, empty past the end
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  // The warp's two rows: query vectors v0 = 16 mt + gr and v0 + 8.
  const int v0 = mt * 16 + gr;
  int vl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int vi = v0 + 8 * h;
    vl[h] = vi < nvec ? p.vlen[b * p.S + row0 + vi / p.n_rep] : 0;
  }
  uint32_t qa[C::kF32 ? 1 : HD / 16][4];
  if constexpr (!C::kF32) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int vi = v0 + 8 * (e & 1);
        const int d = ks * 16 + 2 * t + 8 * (e >> 1);
        qa[ks][e] = vi < nvec ? *reinterpret_cast<const uint32_t*>(q_at(vi, d)) : 0u;
      }
    }
  }
  const bool active = mt * 16 < nvec;  // an m-tile with no query vector idles

  float m_st[2] = {kNegInf * 0.5f, kNegInf * 0.5f};
  float l_st[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j landed for every thread; tile j-1's stage is free
    issue(j + kStages - 1);
    if (!active) continue;
    const unsigned char* kst = ring + (j % kStages) * C::kStage;
    const unsigned char* vst = kst + C::kHalf;
    const int key0 = kg * KW;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (C::kF32) {
      qk_f32<HD, NT>(s, qs + mt * 16 * C::LDQ, kst, key0);
    } else {
      qk_bf16<HD, NT>(s, qa, kst, key0);
    }
    const int pbase = k_begin + j * TK + key0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pbase + nt * 8 + 2 * t + (e & 1);
        const bool ok = pos < k_end && pos < vl[e >> 1] && tb[pos / p.bs - blk0] >= 0;
        s[nt][e] = ok ? s[nt][e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_st[h], fmaxf(quad_max(mx[h]), kNegInf * 0.5f));
      alpha[h] = expf(m_st[h] - m_new);
      m_st[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_st[e >> 1]);  // masked: exp(-5e29) == 0
        psum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_st[h] = l_st[h] * alpha[h] + quad_sum(psum[h]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    if constexpr (C::kF32) {
      pv_f32<HD, NT>(o, s, pw, vst, key0);
    } else {
      pv_bf16<HD, NT>(o, s, vst, key0);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go through it

  float* ow = reinterpret_cast<float*>(ring);  // (warp, row, HD + 2): o, m, l
  constexpr int LDW = HD + 2;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ow[(warp * 16 + gr + 8 * (e >> 1)) * LDW + nt * 8 + 2 * t + (e & 1)] = o[nt][e];
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ow[(warp * 16 + gr + 8 * h) * LDW + HD] = m_st[h];
      ow[(warp * 16 + gr + 8 * h) * LDW + HD + 1] = l_st[h];
    }
  }
  __syncthreads();

  // Merge the KG key groups of each query vector; write the output (one
  // split) or this split's partial.
  T* out = static_cast<T*>(p.out);
  const size_t bsh = size_t(p.B) * p.S * p.H;
  for (int idx = tid; idx < nvec * HD; idx += kThreads) {
    const int vi = idx / HD, d = idx % HD;
    const int r = vi % 16, m_tile = vi / 16;
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < KG; ++k) M = fmaxf(M, ow[((k * MT + m_tile) * 16 + r) * LDW + HD]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float* st = ow + ((k * MT + m_tile) * 16 + r) * LDW;
      const float w = expf(st[HD] - M);
      num += w * st[d];
      den += w * st[HD + 1];
    }
    const int i = row0 + vi / p.n_rep, h = g * p.n_rep + vi % p.n_rep;
    const size_t orow = (size_t(b) * p.S + i) * p.H + h;
    if (p.splits == 1) {
      out[orow * HD + d] = E::from_f(num / fmaxf(den, 1e-30f));
    } else {
      float* w = p.ws + (size_t(split) * bsh + orow) * LDW;
      w[d] = num;
      if (d == 0) {
        w[HD] = M;
        w[HD + 1] = den;
      }
    }
  }
}

// Merge the split partials of each output row (b, i, h): one warp a row.
// Row (b, i) reads splits s < ceil(min(valid_len, MB * bs) / kps), the
// ones its CTAs wrote. Lane j takes splits j, j + 32, ... for the stats
// (their loads in flight together), then every lane its dims lane, lane
// + 32, ... of each split's o, the weight e^(m_s - M) taken by shuffle.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_combine_kernel(Params p) {
  constexpr int LDW = HD + 2;
  const size_t bsh = size_t(p.B) * p.S * p.H;
  const size_t row = size_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= bsh) return;
  const int lane = threadIdx.x & 31;
  const int len = min(p.vlen[row / p.H], p.MB * p.bs);
  const int used = len > 0 ? min((len + p.kps - 1) / p.kps, p.splits) : 0;
  const float* ws = p.ws + row * LDW;
  float M = kNegInf;
  for (int s = lane; s < used; s += 32) M = fmaxf(M, ws[s * bsh * LDW + HD]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float den = 0.f, acc[HD / 32];
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < used; s0 += 32) {
    const int n = min(32, used - s0);
    float e = 0.f;
    if (lane < n) {
      const float* w = ws + (s0 + lane) * bsh * LDW;
      e = expf(w[HD] - M);
      den += e * w[HD + 1];
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float ej = __shfl_sync(0xffffffffu, e, j);
      const float* w = ws + (s0 + j) * bsh * LDW;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) acc[i] += ej * w[lane + 32 * i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  T* out = static_cast<T*>(p.out) + row * HD;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) out[lane + 32 * i] = Elem<T>::from_f(acc[i] / fmaxf(den, 1e-30f));
}

template <typename T, int HD, int KG>
cudaError_t launch_kg(const Params& p, cudaStream_t stream) {
  constexpr int smem = Cfg<T, HD>::kSmem;
  auto kernel = ragged_paged_attention_kernel<T, HD, KG>;
  // Always: the 48 KB default counts the static table too.
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.row_tiles * p.splits, p.KV, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const size_t rows = size_t(p.B) * p.S * p.H;
  ragged_paged_attention_combine_kernel<T, HD>
      <<<unsigned((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int m_tiles = (p.rows_per_cta * p.n_rep + 15) / 16;
  if (m_tiles == 1) return launch_kg<T, HD, 4>(p, stream);
  if (m_tiles == 2) return launch_kg<T, HD, 2>(p, stream);
  return launch_kg<T, HD, 1>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. rows_per_cta, splits and kps come
// from the wrapper's `_split_plan`; ws holds splits * B*S*H * (HD + 2)
// floats when splits > 1. Returns a cudaError_t (0 = launched).
int dstack_ragged_paged_attention(const void* q, const void* k, const void* v,
                                  const int* tables, const int* vlen, void* out, float* ws,
                                  int B, int S, int H, int KV, int HD, int NB, int bs, int MB,
                                  int rows_per_cta, int splits, int kps, float scale,
                                  int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || MB <= 0 || NB <= 0)
    return cudaErrorInvalidValue;
  const int n_rep = H / KV;
  const long long cols = (long long)MB * bs;
  if (rows_per_cta <= 0 || rows_per_cta * n_rep > kMaxVec || splits <= 0 || kps <= 0 ||
      kps % kKeyAlign != 0 || (long long)(splits - 1) * kps >= cols ||
      (long long)splits * kps < cols || (kps - 1) / bs + 2 > kMaxTable ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.tables = tables;
  p.vlen = vlen;
  p.out = out;
  p.ws = ws;
  p.B = B;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.NB = NB;
  p.bs = bs;
  p.MB = MB;
  p.n_rep = n_rep;
  p.rows_per_cta = rows_per_cta;
  p.row_tiles = (S + rows_per_cta - 1) / rows_per_cta;
  p.splits = splits;
  p.kps = kps;
  p.scale = scale;  // hd ** -0.5 rounded to f32 by the caller, as the reference
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (HD == 32) return launch<float, 32>(p, st);
    if (HD == 64) return launch<float, 64>(p, st);
    if (HD == 128) return launch<float, 128>(p, st);
  } else if (dtype == 1) {
    if (HD == 32) return launch<__nv_bfloat16, 32>(p, st);
    if (HD == 64) return launch<__nv_bfloat16, 64>(p, st);
    if (HD == 128) return launch<__nv_bfloat16, 128>(p, st);
  }
  return cudaErrorInvalidValue;
}

const char* dstack_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
