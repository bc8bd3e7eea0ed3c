// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Both kernels replace the TPU kernel `_paged_kernel` (dstack_tpu/workloads/
// paged_attention.py:222, launched by `_ragged_attention_pallas`). Same
// function: query row (b, i) of head h attends the cache positions
// p < valid_len[b, i] of slot b, position p living at row p % bs of pool
// block tables[b, p / bs]; table entries outside [0, NB) (the pad sentinel
// NB) are never read and their positions are masked. Softmax state (m, l,
// acc) is f32, with the floors m >= NEG_INF/2 and l >= 1e-30 of the
// reference; probabilities are rounded to the storage dtype before the PV
// product, as the TPU kernel's `p.astype(v.dtype)`.
//
// Two bodies, picked per call from shapes alone (`_plan` in
// paged_attention.py), because what bounds the function on this card
// changes with the rows a call carries. Per byte of HBM, a call of S rows
// over a context of L positions does ~n_rep * S flop when the context was
// cached before the call (start >> S) and ~0.4 * S at start 0 (H 32, KV 8:
// q and the output count too), against the ~295 flop/byte at which the
// H100's tensor cores, and not HBM, become the limit.
//
// ragged_paged_attention_kernel (+ its combine): decode steps (S 1, 2 flop
// per K/V byte per query head), speculative verifies (S = k + 1), f32, and
// bf16 chunks under PREFILL_MIN_ROWS rows, which stay under the line or
// near it: bound by the bytes of K and V read from HBM. So the design
// keeps enough bytes in flight on every SM, and reads each K/V row once:
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
// ragged_paged_attention_prefill_sm90_kernel: bf16 prompt chunks of
// PREFILL_MIN_ROWS rows or more (hd 64, 128). The benchmark's docs chunks
// (2048-8192 rows at start 0) do 800-3300 flop per byte: bound by
// operations, where only wgmma reaches the card's rate. So it is the flash
// forward's design (`sm90::fwd_body` in flash_attention.cu, the shared
// pieces in sm90.cuh) re-fed from the block pool:
//   - one CTA per (128-vector query tile, KV head, slot), no KV split and
//     no workspace, the last (heaviest) row tiles first. A tile packs the
//     KV head's GQA group: 128 / n_rep rows x n_rep heads (32 x 4 at the
//     cells' H 32, KV 8), one TMA box of q viewed (HD, H, S, B), so each
//     K/V tile reaches shared memory once per group;
//   - a producer warpgroup whose one thread issues TMA copies into a
//     2-stage full/empty mbarrier ring, two consumer warpgroups of 64
//     vectors, setmaxnreg 24/240; S = Q K^T (wgmma m64n128k16, both
//     operands swizzled in shared memory) and the previous tile's
//     O += P V (P rounded to bf16 in registers) in flight together, the
//     softmax under the other warpgroup's products;
//   - K/V gathered by TMA: a 128-key tile is 128 / bs pool blocks, one
//     copy per (block, 64-column box) from a map over the layer's pool
//     viewed (HD, KV, bs, NB); a sentinel entry, and a block wholly at or
//     past the CTA's largest valid length, is asked at block NB, outside
//     the map, so TMA zero-fills it and reads nothing;
//   - masking by valid_len: row r sees keys p < valid_len[b, r] (clipped
//     to MB * bs) outside sentinel blocks; only tiles that reach past the
//     CTA's least valid length or hold a sentinel block are masked, and no
//     tile at or past its largest is loaded. The slot's table lives in
//     shared memory (MB <= 8192);
//   - the NaN guard: in the tile that holds the largest valid length, the
//     K/V rows past it in the last pool block are zeroed in shared memory
//     before either product reads them;
//   - the same f32 (m, l, acc) and floors as the split kernel; a row of
//     valid length 0 gives 0.
//
// Launch contract: the kernels allocate nothing (the wrapper passes the
// split partials' workspace), run on the caller's stream, and the C entry
// points return cudaGetLastError() after each launch; the prefill
// kernel's tensor maps are encoded on the host at each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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


// ------------------------------------------------ bf16 prompt chunks for Hopper

namespace sm90 {

constexpr int kMaxPrefillTable = 8192;  // a slot's table entries, kept in shared memory

struct PrefillParams {
  const int* tables;  // (B, MB)
  const int* vlen;    // (B, S)
  void* out;          // (B, S, H, HD) bf16
  int B, S, H, KV, NB, bs, MB;
  int pack;      // query heads of one KV head a CTA carries; kBQ / pack query rows
  int bs_shift;  // log2(bs)
  float scale;
};

struct PrefillMaps {
  CUtensorMap q;     // (B, S, H, HD) as 4-d (HD, H, S, B), boxes (kChunkCols, pack, rows, 1)
  CUtensorMap k, v;  // (NB, bs, KV, HD) as 4-d (HD, KV, bs, NB), boxes (kChunkCols, 1, bs, 1)
};

template <int HD>
struct PrefillCfg {
  using T = Tile<HD>;
  static constexpr uint32_t kQ = 0, kK = T::kTileBytes, kV = kK + kStages * T::kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * T::kTileBytes;
  static constexpr uint32_t kTable = kBar + 8 * (1 + 4 * kStages);  // the slot's table
  // 1 + 4 * kStages mbarriers, the table, and slack to align the base to 1024 bytes.
  static size_t smem(int MB) { return kTable + 4 * size_t(MB) + 1024; }
};

// The NaN guard: in stage 0 (the first tile, keys k0 ..., which holds key
// hi_len - 1), zero the K and V rows of the keys from hi_len to the end of
// their pool block. No row sees them, but a pool block is read whole and
// 0 * NaN inside a tensor-core sum is NaN. Blocks wholly at or past hi_len
// were never read (TMA zero-filled them). Run by one consumer warpgroup
// (t its thread) before either issues a product on the stage.
template <int HD>
__device__ __forceinline__ void zero_tail(uint32_t base, uint32_t full_v, int hi_len, int k0,
                                          int bs, int t) {
  using T = Tile<HD>;
  using C = PrefillCfg<HD>;
  const int first = hi_len - k0;
  const int last = min((hi_len + bs - 1) / bs * bs, k0 + kBK) - k0;
  if (first >= last) return;
  mbar_wait(full_v, 0);
  constexpr int kUnits = T::kRowBytes / 16;  // 16-byte units of a row of a column block
  for (int u = t; u < (last - first) * T::kChunks * kUnits; u += 128) {
    const int row = first + u / (T::kChunks * kUnits), w = u % (T::kChunks * kUnits);
    // The swizzle permutes a row's units inside its kRowBytes: zeroing all
    // of them zeroes the row.
    const uint32_t off = (w / kUnits) * kBK * T::kRowBytes + row * T::kRowBytes + (w % kUnits) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(base + C::kK + off), "r"(0)
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(base + C::kV + off), "r"(0)
                 : "memory");
  }
  // Generic-proxy writes made visible to the wgmma (async proxy) reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One CTA per (query tile, group of `pack` heads of one KV head, slot b):
// grid (row_tiles * H / pack, B), kThreads threads, the last row tiles
// (the heaviest) first. Query vector v of the tile is row r0 + v / pack,
// head h0 + v % pack.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_paged_attention_prefill_sm90_kernel(const __grid_constant__ PrefillMaps maps,
                                               PrefillParams p) {
  using T = Tile<HD>;
  using C = PrefillCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_len[2];  // the CTA's least and largest valid length
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's period
  int* tb = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kTable);
  const uint32_t full_q = base + C::kBar;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int rows = kBQ / p.pack;
  const int groups = p.H / p.pack;
  const int tile = (p.S + rows - 1) / rows - 1 - int(blockIdx.x) / groups;
  const int h0 = int(blockIdx.x) % groups * p.pack;
  const int g = h0 / (p.H / p.KV);
  const int b = blockIdx.y;
  const int r0 = tile * rows;
  const int cols = p.MB * p.bs;

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
  // The producer warpgroup copies the slot's table; the first consumer
  // warp takes the least and largest valid length of the tile's rows.
  if (threadIdx.x < 128) {
    for (int i = threadIdx.x; i < p.MB; i += 128) {
      const int e = p.tables[size_t(b) * p.MB + i];
      tb[i] = (e >= 0 && e < p.NB) ? e : -1;
    }
  } else if (threadIdx.x < 160) {
    const int lane = threadIdx.x - 128;
    int lo = cols, hi = 0;
    for (int r = lane; r < rows && r0 + r < p.S; r += 32) {
      const int len = min(max(p.vlen[size_t(b) * p.S + r0 + r], 0), cols);
      lo = min(lo, len);
      hi = max(hi, len);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_len[0] = lo;
      s_len[1] = hi;
    }
  }
  __syncthreads();
  const int lo_len = s_len[0], hi_len = s_len[1];
  const int n_kt = (hi_len + kBK - 1) / kBK;  // no tile at or past the largest valid length

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full. Tile i of the loop (keys
    // k0 = (n_kt - 1 - i) * kBK ...) goes to stage i % kStages, one TMA box
    // per (pool block, column block); a sentinel block, or one wholly at
    // or past hi_len, is asked at block NB, past the map: zeros, no read.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_kt > 0) {
      mbar_expect_tx(full_q, T::kTileBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load4(base + C::kQ + c * kBQ * T::kRowBytes, &maps.q, full_q, c * T::kChunkCols, h0,
                  r0, b);
      const int per_tile = kBK >> p.bs_shift;
      const uint32_t box = uint32_t(p.bs) * T::kRowBytes;
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (n_kt - 1 - i) * kBK;
#pragma unroll 1
        for (int kv = 0; kv < 2; ++kv) {
          const uint32_t empty = (kv ? empty_v : empty_k) + 8 * s;
          const uint32_t full = (kv ? full_v : full_k) + 8 * s;
          const uint32_t dst = base + (kv ? C::kV : C::kK) + s * T::kTileBytes;
          const CUtensorMap* map = kv ? &maps.v : &maps.k;
          mbar_wait(empty, parity);
          mbar_expect_tx(full, T::kTileBytes);
          for (int j = 0; j < per_tile; ++j) {
            const int pos = k0 + (j << p.bs_shift);
            const int e = pos < hi_len ? tb[pos >> p.bs_shift] : -1;
#pragma unroll
            for (int c = 0; c < T::kChunks; ++c)
              tma_load4(dst + c * kBK * T::kRowBytes + j * box, map, full, c * T::kChunkCols, g,
                        0, e >= 0 ? e : p.NB);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: vectors 64 cw ...
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, c4 = lane % 4;
    const int v0 = cw * 64 + warp * 16 + lane / 4;  // this thread's vectors: v0, v0 + 8
    int vl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + (v0 + 8 * r) / p.pack;
      vl[r] = row < p.S ? min(max(p.vlen[size_t(b) * p.S + row], 0), cols) : 0;
    }
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf * 0.5f, kNegInf * 0.5f};
    float l[2] = {0.f, 0.f};
    if (n_kt > 0) {
      const uint32_t q_tile = base + C::kQ + cw * 64 * T::kRowBytes;
      // The mask runs only on a tile that reaches past the CTA's least
      // valid length or holds a sentinel block (a tile past the table's
      // end reaches past every valid length).
      const int per_tile = kBK >> p.bs_shift;
      auto masked = [&](int k0) {
        const int e = (k0 >> p.bs_shift) + lane;
        return k0 + kBK > lo_len ||
               __any_sync(0xffffffffu, lane < per_tile && e < p.MB && tb[e] < 0);
      };
      // A key is masked at or past its row's valid length (clipped to the
      // table's MB * bs positions) and in a sentinel block.
      auto drop = [&](int col, int r) { return col >= vl[r] || tb[col >> p.bs_shift] < 0; };
      uint32_t pa[kBK / 16][4];  // the previous tile's P, read by its P V in flight
      // Turns, as the flash forward's: a warpgroup issues its products
      // between sync(own barrier) and arrive(the other's).
      const int own_turn = kTurnBar + cw, other_turn = kTurnBar + 1 - cw;
      if (cw == 1) named_arrive(other_turn);
      mbar_wait(full_q, 0);

      // Tile 0 (keys (n_kt - 1) * kBK ...): S alone.
      {
        float sc[64];
        float alpha[2];
        const int k0 = (n_kt - 1) * kBK;
        mbar_wait(full_k, 0);
        if (cw == 0) zero_tail<HD>(base, full_v, hi_len, k0, p.bs, t);
        named_sync(own_turn);
        wgmma_fence();
        issue_qk<HD>(sc, q_tile, base + C::kK);
        wgmma_commit();
        named_arrive(other_turn);
        wgmma_wait<0>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_k);
        softmax_tile(sc, m, l, alpha, p.scale, c4, k0, masked(k0), drop);
        to_a_frag(sc, pa);
      }
      // Tile i: its S = Q K^T and tile i-1's O += P V in flight together.
      for (int i = 1; i < n_kt; ++i) {
        const int s = i % kStages, sp = (i - 1) % kStages;
        const int k0 = (n_kt - 1 - i) * kBK;
        float sc[64];
        float alpha[2];
        mbar_wait(full_k + 8 * s, (i / kStages) & 1);
        mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
        fence_regs(pa);
        fence_regs(o);
        named_sync(own_turn);
        wgmma_fence();
        issue_qk<HD>(sc, q_tile, base + C::kK + s * T::kTileBytes);
        wgmma_commit();
        issue_pv<HD>(o, pa, base + C::kV + sp * T::kTileBytes);
        wgmma_commit();
        named_arrive(other_turn);
        wgmma_wait<1>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_k + 8 * s);
        softmax_tile(sc, m, l, alpha, p.scale, c4, k0, masked(k0), drop);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v + 8 * sp);
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
      issue_pv<HD>(o, pa, base + C::kV + sl * T::kTileBytes);
      wgmma_commit();
      if (cw == 0) named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }

    // O / max(l, 1e-30) in bf16; a row with valid length 0 gives 0.
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = v0 + 8 * r, row = r0 + v / p.pack;
      if (row >= p.S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = out + ((size_t(b) * p.S + row) * p.H + h0 + v % p.pack) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * c4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, const PrefillParams& p,
                           cudaStream_t stream) {
  using T = Tile<HD>;
  auto kernel = ragged_paged_attention_prefill_sm90_kernel<HD>;
  static const cudaError_t regs = check_regs(kernel);
  if (regs != cudaSuccess) return regs;
  const int rows = kBQ / p.pack;
  PrefillMaps maps;
  const cuuint64_t qd[4] = {cuuint64_t(HD), cuuint64_t(p.H), cuuint64_t(p.S), cuuint64_t(p.B)};
  const cuuint64_t qs[3] = {cuuint64_t(HD) * 2, cuuint64_t(p.H) * HD * 2,
                            cuuint64_t(p.S) * p.H * HD * 2};
  const cuuint32_t qb[4] = {cuuint32_t(T::kChunkCols), cuuint32_t(p.pack), cuuint32_t(rows), 1};
  const cuuint64_t kd[4] = {cuuint64_t(HD), cuuint64_t(p.KV), cuuint64_t(p.bs), cuuint64_t(p.NB)};
  const cuuint64_t ks[3] = {cuuint64_t(HD) * 2, cuuint64_t(p.KV) * HD * 2,
                            cuuint64_t(p.bs) * p.KV * HD * 2};
  const cuuint32_t kb[4] = {cuuint32_t(T::kChunkCols), 1, cuuint32_t(p.bs), 1};
  cudaError_t e;
  if ((e = encode_bf16(&maps.q, q, 4, qd, qs, qb, T::kSwizzle)) != cudaSuccess) return e;
  if ((e = encode_bf16(&maps.k, k, 4, kd, ks, kb, T::kSwizzle)) != cudaSuccess) return e;
  if ((e = encode_bf16(&maps.v, v, 4, kd, ks, kb, T::kSwizzle)) != cudaSuccess) return e;
  const size_t smem = PrefillCfg<HD>::smem(p.MB);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(unsigned((p.S + rows - 1) / rows * (p.H / p.pack)), unsigned(p.B));
  kernel<<<grid, kThreads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace sm90

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

// The bf16 prompt-chunk kernel (hd 64 or 128). pack: query heads of one KV
// head a CTA carries (divides H / KV and 128), bs a power of two in
// [16, 128], MB <= 8192. Returns a cudaError_t (0 = launched).
int dstack_ragged_paged_prefill(const void* q, const void* k, const void* v, const int* tables,
                                const int* vlen, void* out, int B, int S, int H, int KV, int HD,
                                int NB, int bs, int MB, int pack, float scale, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || KV <= 0 || H % KV != 0 || NB <= 0 || MB <= 0 ||
      MB > sm90::kMaxPrefillTable || pack <= 0 || (H / KV) % pack != 0 ||
      sm90::kBQ % pack != 0 || bs < 16 || bs > sm90::kBK || (bs & (bs - 1)) != 0)
    return cudaErrorInvalidValue;
  sm90::PrefillParams p;
  p.tables = tables;
  p.vlen = vlen;
  p.out = out;
  p.B = B;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.NB = NB;
  p.bs = bs;
  p.MB = MB;
  p.pack = pack;
  p.bs_shift = __builtin_ctz(bs);
  p.scale = scale;  // hd ** -0.5 rounded to f32 by the caller, as the reference
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64) return sm90::launch_prefill<64>(q, k, v, p, st);
  if (HD == 128) return sm90::launch_prefill<128>(q, k, v, p, st);
  return cudaErrorInvalidValue;
}

const char* dstack_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
