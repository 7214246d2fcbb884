// Causal / sliding-window GQA flash prefill attention for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel, called through flash_attention_folded). It computes, for
// every query row of every (batch, kv head, query-group head),
//
//     o[q] = softmax_k(scale * q . k  masked to the causal / window band) . v
//
// with an fp32 running max m, sum l and accumulator, so the (S x S) score
// matrix never reaches device memory. Masks follow the reference exactly:
// kpos < seq, kpos <= qpos (causal), kpos > qpos - window (window > 0), the
// masked score is the finite NEG_INF = -2^30, and l is floored at 1e-30.
//
// What bounds it on the H100: at the serving shape (B*K = 64, G = 2,
// S = 2048, hd = 128) the causal band is ~1.4e11 FLOPs against ~0.2 GB of
// q/k/v/o, far above the card's ridge point, so it is bound by operations.
// This first version does its products with scalar fp32 FMAs (no tensor
// cores: the float32 path must stay exact to 2e-5), so it runs against the
// fp32 CUDA-core rate, not the bf16 tensor-core peak. Its design:
//
//   * one block of 256 threads owns a (64-row q tile, kv-head row, group
//     head); the TPU's sequential kv-tile grid axis becomes a loop inside the
//     block, over only the kv tiles that meet the causal / window band;
//   * q, k and v are read in place through element strides in the model's
//     (B, S, K, G, hd) / (B, S, K, hd) layout (no folded copy), converted to
//     fp32 and staged in dynamic shared memory (117 KB at hd 128);
//   * each thread owns a 4 x (kv tile / 16) block of scores and 4 rows of
//     the output in float4 columns 4 * (tx + 16 c) (at hd 112 the second
//     column exists for tx < 12 only: every use is guarded by col < HD,
//     and shared-memory rows of 116 floats keep 16-byte alignment and stay
//     free of bank conflicts); the row max and sum reduce over the
//     16 threads of a row with warp shuffles; rows are padded by 4 floats so
//     the 16-byte shared-memory reads are free of bank conflicts;
//   * the ragged tail is masked with the true seq: rows past it are zero in
//     shared memory and are never written, so nothing is padded;
//   * q tiles are issued heaviest first (the last causal tile has the most kv
//     tiles), so the tail of the grid is short.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, finite as in the reference
constexpr int kThreads = 256;
constexpr int kBQ = 64;                     // query rows per block

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides: q and o over (B, K, G, S), k and v over (B, K, S); the
  // head_dim stride is 1
  long long q_sb, q_sk, q_sg, q_ss;
  long long k_sb, k_sk, k_ss;
  long long v_sb, v_sk, v_ss;
  long long o_sb, o_sk, o_sg, o_ss;
  int K, S, causal, window;
  float scale;
};

// 4 consecutive elements -> fp32 (16 bytes of float, 8 bytes of bf16)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned*>(&a);
    raw.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// reductions over the 16 lanes that share a query row (lane groups of 16)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// kv rows per tile: 64, or 32 at head_dim 256 so the tiles fit one block
template <int HD>
constexpr int kv_tile() { return HD >= 256 ? 32 : 64; }

template <int HD, int BKV>
constexpr int smem_floats() {
  return kBQ * (HD + 4) + BKV * (HD + 4) + BKV * HD + kBQ * (BKV + 4);
}

template <typename T, int HD, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const FlashArgs a) {
  constexpr int QS = HD + 4;          // padded row stride of sQ and sK
  constexpr int PS = BKV + 4;         // padded row stride of sP
  constexpr int NC = BKV / 16;        // score columns per thread
  constexpr int V4 = HD / 4;          // float4s per head row
  constexpr int NV = (V4 + 15) / 16;  // output float4 columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + BKV * QS;
  float* sP = sV + BKV * HD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int g = blockIdx.y;
  const int b = blockIdx.z / a.K, kh = blockIdx.z % a.K;
  const int q0 = qt * kBQ;
  const int S = a.S;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + kh * a.q_sk +
                g * a.q_sg;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sk;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sk;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + kh * a.o_sk + g * a.o_sg;

  // the q tile, scaled, rows past seq zero
  for (int i = tid; i < kBQ * V4; i += kThreads) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = load4(qp + (long long)(q0 + r) * a.q_ss + c);
      x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    }
    *reinterpret_cast<float4*>(sQ + r * QS + c) = x;
  }

  // kv tiles that meet the band of this q tile
  int hi = S;
  if (a.causal) hi = min(hi, q0 + kBQ);
  int lo = 0;
  if (a.window) lo = max(0, q0 - a.window + 1);
  const int j0 = lo / BKV, j1 = (hi + BKV - 1) / BKV;

  float m[4], l[4], acc[4][NV][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * BKV;
    __syncthreads();                  // the last tile's sK/sV/sP are consumed
    for (int i = tid; i < BKV * V4; i += kThreads) {
      const int r = i / V4, c = (i % V4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < S) {
        kx = load4(kp + (long long)(k0 + r) * a.k_ss + c);
        vx = load4(vp + (long long)(k0 + r) * a.v_ss + c);
      }
      *reinterpret_cast<float4*>(sK + r * QS + c) = kx;
      *reinterpret_cast<float4*>(sV + r * HD + c) = vx;
    }
    __syncthreads();

    // scores: rows 4*ty + i, columns tx + 16*c
    float s[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * QS + d);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kv[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[i][c] = fma4(qv[i], kv[c], s[i][c]);
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool ok = kpos < S;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window) ok = ok && kpos > qpos - a.window;
        if (!ok) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        sP[r * PS + tx + 16 * c] = p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

    // acc += P . V: output columns 4 * (tx + 16 * c) .. +3
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * PS + kk);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = 4 * (tx + 16 * c);
        if (col < HD) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vv =
                *reinterpret_cast<const float4*>(sV + (kk + u) * HD + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z : pv[i].w;
              acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = 4 * (tx + 16 * c);
      if (col < HD)
        store4(op + (long long)qpos * a.o_ss + col,
               make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                           acc[i][c][2] * inv, acc[i][c][3] * inv));
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const FlashArgs& a, int n_q, int G, int BK,
                      cudaStream_t st) {
  constexpr int BKV = kv_tile<HD>();
  constexpr size_t smem = sizeof(float) * smem_floats<HD, BKV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_kernel<T, HD, BKV><<<dim3(n_q, G, BK), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const FlashArgs& a, int hd, int n_q, int G, int BK,
                     cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, n_q, G, BK, st);
    case 64: return launch_hd<T, 64>(a, n_q, G, BK, st);
    case 112: return launch_hd<T, 112>(a, n_q, G, BK, st);
    case 128: return launch_hd<T, 128>(a, n_q, G, BK, st);
    case 256: return launch_hd<T, 256>(a, n_q, G, BK, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (B, K, G, S, hd) and k, v: (B, K, S, hd) addressed through the 14
// element strides in `st` (q b,k,g,s; k b,k,s; v b,k,s; o b,k,g,s); head_dim
// contiguous. dtype 0 = float32, 1 = bfloat16. Launches on `stream` and
// returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* st, int B, int K, int G,
                           int S, int hd, int causal, int window, float scale,
                           int dtype, void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = st[0]; a.q_sk = st[1]; a.q_sg = st[2]; a.q_ss = st[3];
  a.k_sb = st[4]; a.k_sk = st[5]; a.k_ss = st[6];
  a.v_sb = st[7]; a.v_sk = st[8]; a.v_ss = st[9];
  a.o_sb = st[10]; a.o_sk = st[11]; a.o_sg = st[12]; a.o_ss = st[13];
  a.K = K; a.S = S; a.causal = causal; a.window = window; a.scale = scale;
  const int n_q = (S + kBQ - 1) / kBQ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_t<float>(a, hd, n_q, G, B * K, s);
  else if (dtype == 1) err = launch_t<__nv_bfloat16>(a, hd, n_q, G, B * K, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
