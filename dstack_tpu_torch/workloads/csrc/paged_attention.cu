// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (dstack_tpu/workloads/
// paged_attention.py, launched by `_ragged_attention_pallas`). Same
// function: query row (b, i) of head h attends the cache positions
// p < valid_len[b, i] of slot b, position p living at row p % bs of pool
// block tables[b, p / bs]; table entries outside [0, NB) (the pad sentinel
// NB) are never read and their positions are masked. Softmax state (m, l,
// acc) is f32, with the floors m >= NEG_INF/2 and l >= 1e-30 of the
// reference; probabilities are rounded to the storage dtype before the PV
// product, as the TPU kernel's `p.astype(v.dtype)`.
//
// What bounds it on this card: the bytes of K and V read from HBM. A
// decode step does 2 flops per K/V element it reads per query head, far
// below the ~295 flop/byte the H100 needs before its tensor cores are the
// limit. The design therefore reads each K/V block once:
//   - one CTA per (slot b, KV head g, tile of query rows) carries all
//     n_rep = H / KV query heads of head g, so a block is fetched once for
//     its whole GQA group (the Pallas grid (b, h, mb) with `hi // n_rep`
//     streamed every block n_rep times);
//   - the table-column axis, sequential on the TPU, is a loop inside the
//     CTA that stops at the columns the CTA's rows need,
//     ceil(max valid_len / bs);
//   - each loop step stages a tile of up to 64 keys (whole blocks) of K
//     and V in shared memory with 16-byte loads; positions no row of the
//     CTA may see (sentinel blocks, past the CTA's longest row) are
//     zero-filled instead of loaded, so garbage or NaN in unused blocks
//     cannot reach the output even through a 0 * NaN product.
// Inside the tile, lane t of a warp owns key t for the QK dot products
// (K rows padded by one 32-bit word so the 32 lanes hit 32 banks) and
// lane d owns output dims d, d+32, ... for the PV product. No tensor
// cores, TMA or pipelining yet: a simple kernel that is right first.
//
// Launch contract: the kernel allocates nothing, runs on the caller's
// stream, and the C entry point returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxVec = 32;    // (row, head) query vectors per CTA
constexpr int kMaxWarps = 8;
constexpr int kMaxQpw = 4;     // query vectors per warp: 32 / 8
constexpr int kMaxKpl = 4;     // keys per lane per tile: tiles <= 128 keys
constexpr int kTileKeys = 64;  // target keys per tile (whole blocks)
constexpr int kLoads = 8;      // 16-byte loads in flight per thread

struct Params {
  const void* q;        // (B, S, H, HD)
  const void* k;        // (NB, bs, KV, HD)
  const void* v;        // (NB, bs, KV, HD)
  const int* tables;    // (B, MB)
  const int* vlen;      // (B, S)
  void* out;            // (B, S, H, HD)
  int S, H, KV, NB, bs, MB;
  int n_rep, rows_per_cta, bpt, tk;
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float2 pair(const float* p) {
    return make_float2(p[0], p[1]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// K rows are padded by one 32-bit word: lane t reading word w of row t
// then hits bank (t * (row_words + 1) + w) % 32, distinct across lanes.
template <typename T, int HD>
struct Layout {
  static constexpr int kRow = HD + 4 / sizeof(T);  // padded K row, elements
  __host__ __device__ static size_t k_bytes(int tk) {
    return align16(size_t(tk) * kRow * sizeof(T));
  }
  __host__ __device__ static size_t v_bytes(int tk) {
    return align16(size_t(tk) * HD * sizeof(T));
  }
  __host__ __device__ static size_t q_bytes() {
    return align16(size_t(kMaxVec) * HD * sizeof(float));
  }
  __host__ __device__ static size_t p_bytes(int tk, int nwarps) {
    return align16(size_t(nwarps) * tk * sizeof(float));
  }
  __host__ __device__ static size_t total(int tk, int nwarps, int bpt) {
    return k_bytes(tk) + v_bytes(tk) + q_bytes() + p_bytes(tk, nwarps) +
           align16(size_t(bpt) * sizeof(int));
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
ragged_paged_attention_kernel(Params p) {
  using E = Elem<T>;
  using Lay = Layout<T, HD>;
  constexpr int kDpl = HD / 32;              // output dims per lane
  constexpr int kChunks = HD * sizeof(T) / 16;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * p.rows_per_cta;
  const int nrows = min(p.rows_per_cta, p.S - row0);
  const int nvec = nrows * p.n_rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tk = p.tk;
  const int bs = p.bs;

  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + Lay::k_bytes(tk));
  float* qs = reinterpret_cast<float*>(smem + Lay::k_bytes(tk) + Lay::v_bytes(tk));
  float* ps = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(qs) +
                                       Lay::q_bytes());
  int* tb = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(ps) +
                                   Lay::p_bytes(tk, nwarps));
  __shared__ int s_maxlen;

  const T* q = static_cast<const T*>(p.q);
  // Query vector vi = (row r, head rep) with r = vi / n_rep: staged in f32.
  for (int idx = tid; idx < nvec * HD; idx += blockDim.x) {
    const int vi = idx / HD, d = idx % HD;
    const int i = row0 + vi / p.n_rep;
    const int h = g * p.n_rep + vi % p.n_rep;
    qs[idx] = E::to_f(q[((size_t(b) * p.S + i) * p.H + h) * HD + d]);
  }
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < nrows; ++r) m = max(m, p.vlen[b * p.S + row0 + r]);
    s_maxlen = min(m, p.MB * bs);
  }
  __syncthreads();
  const int maxlen = s_maxlen;
  const int n_cols = (maxlen + bs - 1) / bs;

  float m_st[kMaxQpw], l_st[kMaxQpw], acc[kMaxQpw][kDpl];
  int vl[kMaxQpw];
#pragma unroll
  for (int qi = 0; qi < kMaxQpw; ++qi) {
    m_st[qi] = kNegInf * 0.5f;
    l_st[qi] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[qi][i] = 0.f;
    const int vi = warp + qi * nwarps;
    vl[qi] = vi < nvec ? p.vlen[b * p.S + row0 + vi / p.n_rep] : 0;
  }

  const char* kbase = static_cast<const char*>(p.k);
  const char* vbase = static_cast<const char*>(p.v);
  for (int j0 = 0; j0 < n_cols; j0 += p.bpt) {
    if (tid < p.bpt) {
      const int j = j0 + tid;
      int blk = -1;
      if (j < n_cols) {
        const int t = p.tables[b * p.MB + j];
        if (t >= 0 && t < p.NB) blk = t;  // sentinel: never read, masked
      }
      tb[tid] = blk;
    }
    __syncthreads();
    // kLoads 16-byte loads per thread are issued before any is stored, so
    // their HBM latencies overlap instead of adding up.
    const int n_chunks = tk * kChunks;
    for (int c0 = 0; c0 < n_chunks; c0 += kLoads * blockDim.x) {
      uint4 kk[kLoads], vv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = c0 + u * blockDim.x + tid;
        kk[u] = make_uint4(0, 0, 0, 0);
        vv[u] = make_uint4(0, 0, 0, 0);
        if (c < n_chunks) {
          const int t = c / kChunks, ch = c % kChunks;
          const int blk = tb[t / bs];
          if (blk >= 0 && j0 * bs + t < maxlen) {
            const size_t off = ((size_t(blk) * bs + t % bs) * p.KV + g) * HD * sizeof(T) +
                               size_t(ch) * 16;
            kk[u] = *reinterpret_cast<const uint4*>(kbase + off);
            vv[u] = *reinterpret_cast<const uint4*>(vbase + off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = c0 + u * blockDim.x + tid;
        if (c < n_chunks) {
          const int t = c / kChunks, ch = c % kChunks;
          uint32_t* kd = reinterpret_cast<uint32_t*>(ks + size_t(t) * Lay::kRow) + ch * 4;
          kd[0] = kk[u].x;
          kd[1] = kk[u].y;
          kd[2] = kk[u].z;
          kd[3] = kk[u].w;
          *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(vs + size_t(t) * HD) +
                                    ch * 16) = vv[u];
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int qi = 0; qi < kMaxQpw; ++qi) {
      const int vi = warp + qi * nwarps;
      if (vi >= nvec) break;  // uniform across the warp
      const float* qv = qs + vi * HD;
      float s[kMaxKpl];
      float tmax = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kMaxKpl; ++kk) {
        const int t = lane + 32 * kk;
        s[kk] = kNegInf;
        if (t < tk && tb[t / bs] >= 0 && j0 * bs + t < vl[qi]) {
          const T* kr = ks + size_t(t) * Lay::kRow;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; d += 2) {
            const float2 kf = E::pair(kr + d);
            dot = fmaf(qv[d], kf.x, dot);
            dot = fmaf(qv[d + 1], kf.y, dot);
          }
          s[kk] = dot * p.scale;
        }
        tmax = fmaxf(tmax, s[kk]);
      }
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m_st[qi], fmaxf(tmax, kNegInf * 0.5f));
      const float alpha = expf(m_st[qi] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxKpl; ++kk) {
        const int t = lane + 32 * kk;
        if (t < tk) {
          const float pt = expf(s[kk] - m_new);  // masked: exp(-5e29) == 0
          psum += pt;
          ps[warp * tk + t] = E::round(pt);
        }
      }
      psum = warp_sum(psum);
      l_st[qi] = l_st[qi] * alpha + psum;
      m_st[qi] = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[qi][i] *= alpha;
      const float* pw = ps + warp * tk;
      for (int t = 0; t < tk; ++t) {
        const float pt = pw[t];
        const T* vr = vs + size_t(t) * HD;
#pragma unroll
        for (int i = 0; i < kDpl; ++i) acc[qi][i] = fmaf(pt, E::to_f(vr[lane + 32 * i]), acc[qi][i]);
      }
      __syncwarp();
    }
    __syncthreads();  // the next tile overwrites ks, vs and tb
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int qi = 0; qi < kMaxQpw; ++qi) {
    const int vi = warp + qi * nwarps;
    if (vi >= nvec) break;
    const int i = row0 + vi / p.n_rep;
    const int h = g * p.n_rep + vi % p.n_rep;
    const float denom = fmaxf(l_st[qi], 1e-30f);
    T* o = out + ((size_t(b) * p.S + i) * p.H + h) * HD;
#pragma unroll
    for (int d = 0; d < kDpl; ++d) o[lane + 32 * d] = E::from_f(acc[qi][d] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, int nwarps, cudaStream_t stream) {
  const size_t smem = Layout<T, HD>::total(p.tk, nwarps, p.bpt);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = ragged_paged_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.S + p.rows_per_cta - 1) / p.rows_per_cta, p.KV, B);
  kernel<<<grid, nwarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int dstack_ragged_paged_attention(const void* q, const void* k, const void* v,
                                  const int* tables, const int* vlen, void* out,
                                  int B, int S, int H, int KV, int HD, int NB,
                                  int bs, int MB, float scale, int dtype,
                                  void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || MB <= 0 || NB <= 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.tables = tables;
  p.vlen = vlen;
  p.out = out;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.NB = NB;
  p.bs = bs;
  p.MB = MB;
  p.n_rep = H / KV;
  if (p.n_rep > kMaxVec) return cudaErrorInvalidValue;
  p.rows_per_cta = S < kMaxVec / p.n_rep ? S : kMaxVec / p.n_rep;
  const int nvec = p.rows_per_cta * p.n_rep;
  const int nwarps = nvec < kMaxWarps ? nvec : kMaxWarps;
  p.bpt = bs >= kTileKeys ? 1 : kTileKeys / bs;
  p.tk = p.bpt * bs;
  if (p.tk > 32 * kMaxKpl) return cudaErrorInvalidValue;
  p.scale = scale;  // hd ** -0.5 rounded to f32 by the caller, as the reference
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (HD == 32) return launch<float, 32>(p, B, nwarps, st);
    if (HD == 64) return launch<float, 64>(p, B, nwarps, st);
    if (HD == 128) return launch<float, 128>(p, B, nwarps, st);
  } else if (dtype == 1) {
    if (HD == 32) return launch<__nv_bfloat16, 32>(p, B, nwarps, st);
    if (HD == 64) return launch<__nv_bfloat16, 64>(p, B, nwarps, st);
    if (HD == 128) return launch<__nv_bfloat16, 128>(p, B, nwarps, st);
  }
  return cudaErrorInvalidValue;
}

const char* dstack_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
