// One-token flash decode over a KV cache for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel repro/kernels/decode_attention.py:34
// (_decode_kernel, called through decode_attention_folded). For every
// (batch, kv head) row and each of its G grouped query heads,
//
//     o[g] = softmax_c(scale * q[g] . k[c], c < valid_len) . v
//
// with fp32 running max, sum and accumulator; cache slots at or past
// valid_len are neither read nor counted, l is floored at 1e-30.
//
// What bounds it on the H100: one decode step reads the live part of the
// cache once (at qwen3-0.6b batch 8, 2048 valid slots, hd 128 and bf16 that
// is 67 MB of K and V) and does ~4 FLOPs per byte, so it is bound by bytes:
// 0.020 ms at 3.35 TB/s. Its design, to keep bytes in flight on every SM:
//
//   * the cache is read in place in the model's (B, C, K, hd) layout through
//     element strides (the reference's wrapper transposes the whole cache to
//     (B*K, C, hd) on every call, which would triple the bytes moved);
//   * the live slots of each (batch, kv head) row are split over a
//     thread-block cluster of `splits` <= 8 blocks, each taking `chunk`
//     consecutive slots (the wrapper picks both from the rows, G and the
//     valid length; a block past valid_len is empty and keeps m = NEG_INF,
//     l = 0, acc = 0, which weigh exactly nothing in the combine);
//   * a block of 8 warps walks its slots in tiles of TS slots (64, fewer
//     where a tile would pass 16 KB of K), staged with 16-byte cp.async
//     copies into a 3-stage shared-memory ring: tiles t + 1 and t + 2 are in
//     flight while tile t is used (~70 KB per block at hd 128 in bf16; ~108
//     KB of shared memory a block, two blocks per SM).
//     Slots past the block's range are zero-filled, not read. Rows are
//     padded by 16 bytes so a lane per row reads shared memory free of bank
//     conflicts;
//   * scores: each thread computes whole slots' dot products over hd from
//     shared memory, against the scaled fp32 queries of up to 4 heads (all G
//     query heads of a kv head share each staged key); then one warp per
//     head takes the tile's max and sum (one reduction each per tile, not
//     per slot) and turns the scores into weights;
//   * P.V: lanes are spread over pairs of hd columns and read the staged V
//     rows; groups of slots accumulate apart and are summed once at the end;
//   * the block's (m, l, acc) per head are combined across the cluster by
//     its first block through distributed shared memory: one launch, no
//     scratch in device memory. On request the same block writes each
//     head's log-sum-exp, mx + log(l), which sequence-parallel decode
//     needs to merge the outputs of ranks holding other slots.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, finite as in the reference
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;                  // K/V ring depth
constexpr int kMaxSplit = 8;                // portable cluster size

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, K, G) contiguous float32, or null
  // element strides: q and o over (B, K, G), k and v over (B, K, C); the
  // head_dim stride is 1
  long long q_sb, q_sk, q_sg;
  long long k_sb, k_sk, k_sc;
  long long v_sb, v_sk, v_sc;
  long long o_sb, o_sk, o_sg;
  int K, G, valid, chunk;
  float scale;
};

// the shapes of a block's staging for element type T at head_dim HD; TS
// divides the wrapper's GRANULE, so a block's range is whole tiles
template <typename T, int HD>
struct Tile {
  static constexpr int E16 = 16 / sizeof(T);      // elements per 16 bytes
  static constexpr int TS = 64 * HD * sizeof(T) <= 16384   ? 64
                            : 32 * HD * sizeof(T) <= 16384 ? 32
                                                           : 16;
  static constexpr int RS = HD + E16;             // padded row stride
  static constexpr int CH = HD / E16;             // 16-byte chunks per row
  static constexpr int U = HD / 2;                // column pairs
  static constexpr int SG = kThreads / U;         // slot groups in P.V
  static_assert(HD % E16 == 0 && SG >= 1, "head_dim");
};

template <typename T, int HD, int GC>
constexpr size_t smem_bytes() {
  using L = Tile<T, HD>;
  return sizeof(T) * 2 * kStages * L::TS * L::RS +
         sizeof(float) * (GC * HD + GC * L::TS + 3 * GC + L::SG * GC * HD);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of shared memory -> fp32
template <typename T>
__device__ __forceinline__ void load16(const T* p,
                                       float (&out)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (std::is_same<T, float>::value)
    return *reinterpret_cast<const float2*>(p);
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void store_one(T* p, float x) {
  if constexpr (std::is_same<T, float>::value) *p = x;
  else *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (splits, ceil(G / GC), B * K); the cluster spans the `splits` blocks
// of one (row, head group)
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeArgs a) {
  using L = Tile<T, HD>;
  constexpr int TS = L::TS, RS = L::RS, CH = L::CH, E16 = L::E16;
  constexpr int U = L::U, SG = L::SG;
  static_assert(GC <= kWarps, "one softmax warp per head");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);          // kStages x TS x RS
  T* sV = sK + kStages * TS * RS;
  float* sQ = reinterpret_cast<float*>(sV + kStages * TS * RS);  // GC x HD
  float* sP = sQ + GC * HD;                        // GC x TS
  float* sCorr = sP + GC * TS;                     // GC
  float* sM = sCorr + GC;                          // GC
  float* sL = sM + GC;                             // GC
  float* sAcc = sL + GC;                           // SG x GC x HD

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int splits = cluster.num_blocks();
  const int g0 = blockIdx.y * GC;
  const int b = blockIdx.z / a.K, kh = blockIdx.z % a.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this block's slots [c0, c1)
  const int c0 = min(rank * a.chunk, a.valid);
  const int c1 = min(c0 + a.chunk, a.valid);
  const int ntile = (c1 - c0 + TS - 1) / TS;

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sk;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sk;

  auto load_tile = [&](int t, int stage) {
    const int base = c0 + t * TS;
    T* dk = sK + stage * TS * RS;
    T* dv = sV + stage * TS * RS;
    for (int i = tid; i < TS * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * E16;
      const bool in = base + r < c1;
      const long long slot = in ? base + r : 0;
      cp_async16(dk + r * RS + c, kp + slot * a.k_sc + c, in);
      cp_async16(dv + r * RS + c, vp + slot * a.v_sc + c, in);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntile) load_tile(t, t);
    cp_async_commit();
  }

  // the scaled queries; heads past G are zeros
  for (int i = tid; i < GC * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    sQ[i] = g0 + g < a.G
                ? to_float(static_cast<const T*>(a.q)[b * a.q_sb +
                                                      kh * a.q_sk +
                                                      (g0 + g) * a.q_sg + d]) *
                      a.scale
                : 0.f;
  }

  float m_run = kNegInf, l_run = 0.f;   // head `warp`'s state (warp < GC)
  const int u = tid % U, sg = tid / U;  // P.V: column pair, slot group
  float acc[GC][2];
#pragma unroll
  for (int g = 0; g < GC; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<kStages - 2>();       // tile t has landed
    __syncthreads();                    // ... for every thread; tile t - 1 and
                                        // its weights are consumed
    if (t + kStages - 1 < ntile)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const T* tk = sK + (t % kStages) * TS * RS;
    const T* tv = sV + (t % kStages) * TS * RS;
    const int n = min(TS, c1 - c0 - t * TS);   // live slots of this tile

    // scores: whole dot products, one (head, slot) per thread at a time
    for (int i = tid; i < GC * TS; i += kThreads) {
      const int g = i / TS, j = i % TS;
      float dot = kNegInf;
      if (j < n) {
        const T* kr = tk + j * RS;
        const float* qr = sQ + g * HD;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll 4
        for (int c = 0; c < HD; c += E16) {
          float kf[E16];
          load16(kr + c, kf);
#pragma unroll
          for (int e = 0; e < E16; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + c + e);
            d0 = fmaf(qv.x, kf[e], d0);
            d1 = fmaf(qv.y, kf[e + 1], d1);
            d0 = fmaf(qv.z, kf[e + 2], d0);
            d1 = fmaf(qv.w, kf[e + 3], d1);
          }
        }
        dot = d0 + d1;
      }
      sP[i] = dot;
    }
    __syncthreads();

    // one max and one sum per head per tile; the tile's first slot is live,
    // so masked slots weigh exp(NEG_INF - m) = 0 exactly
    if (warp < GC) {
      float* ps = sP + warp * TS;
      float mx = kNegInf;
      for (int j = lane; j < TS; j += 32) mx = fmaxf(mx, ps[j]);
      const float m_new = fmaxf(m_run, warp_max(mx));
      const float corr = expf(m_run - m_new);
      float sum = 0.f;
      for (int j = lane; j < TS; j += 32) {
        const float p = expf(ps[j] - m_new);
        ps[j] = p;
        sum += p;
      }
      l_run = l_run * corr + warp_sum(sum);
      m_run = m_new;
      if (lane == 0) sCorr[warp] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P . V over this thread's slot group
    if (sg < SG) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float corr = sCorr[g];
        acc[g][0] *= corr;
        acc[g][1] *= corr;
      }
#pragma unroll 4
      for (int j = sg; j < n; j += SG) {
        const float2 vv = load2(tv + j * RS + 2 * u);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = sP[g * TS + j];
          acc[g][0] = fmaf(p, vv.x, acc[g][0]);
          acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        }
      }
    }
  }

  // the block's partial state: (m, l) per head, acc summed over slot groups
  if (warp < GC && lane == 0) {
    sM[warp] = m_run;
    sL[warp] = l_run;
  }
  if (sg < SG) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      sAcc[(sg * GC + g) * HD + 2 * u] = acc[g][0];
      sAcc[(sg * GC + g) * HD + 2 * u + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < GC * HD; i += kThreads) {
    float sum = sAcc[i];
#pragma unroll
    for (int s = 1; s < SG; ++s) sum += sAcc[s * GC * HD + i];
    sAcc[i] = sum;
  }

  // combine the cluster's blocks in its first block
  cluster.sync();
  if (rank == 0) {
    T* op = static_cast<T*>(a.o) + b * a.o_sb + kh * a.o_sk;
    for (int i = tid; i < GC * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      if (g0 + g >= a.G) continue;
      float mx = kNegInf;
      for (int r = 0; r < splits; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(sM, r)[g]);
      float sum = 0.f, ls = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float f = expf(cluster.map_shared_rank(sM, r)[g] - mx);
        sum += cluster.map_shared_rank(sAcc, r)[i] * f;
        ls += cluster.map_shared_rank(sL, r)[g] * f;
      }
      store_one(op + (g0 + g) * a.o_sg + d, sum / fmaxf(ls, 1e-30f));
      if (a.lse != nullptr && d == 0)
        a.lse[(b * a.K + kh) * a.G + g0 + g] = mx + logf(ls);
    }
  }
  cluster.sync();                    // keep every block's partials alive
}

template <typename T, int HD, int GC>
cudaError_t launch_gc(const DecodeArgs& a, int BK, int splits,
                      cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, HD, GC>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.G + GC - 1) / GC, BK);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, HD, GC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const DecodeArgs& a, int BK, int splits,
                      cudaStream_t st) {
  if (a.G == 1) return launch_gc<T, HD, 1>(a, BK, splits, st);
  if (a.G == 2) return launch_gc<T, HD, 2>(a, BK, splits, st);
  return launch_gc<T, HD, 4>(a, BK, splits, st);
}

template <typename T>
cudaError_t launch_t(const DecodeArgs& a, int hd, int BK, int splits,
                     cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, BK, splits, st);
    case 64: return launch_hd<T, 64>(a, BK, splits, st);
    case 112: return launch_hd<T, 112>(a, BK, splits, st);
    case 128: return launch_hd<T, 128>(a, BK, splits, st);
    case 256: return launch_hd<T, 256>(a, BK, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (B, K, G, hd) and k, v: (B, K, C, hd) addressed through the 12
// element strides in `st` (q b,k,g; k b,k,c; v b,k,c; o b,k,g); head_dim
// contiguous; slots [0, valid) are live, block r of a row's `splits` takes
// slots [r * chunk, (r + 1) * chunk). `lse`, unless null, receives each
// head's log-sum-exp of its scaled scores over the live slots, (B, K, G)
// contiguous float32. dtype 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError().
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, float* lse, const long long* st, int B,
                            int K, int G,
                            int hd, int valid, int splits, int chunk,
                            float scale, int dtype, void* stream) {
  if (splits < 1 || splits > kMaxSplit || chunk < 1 ||
      (long long)splits * chunk < valid)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.q_sb = st[0]; a.q_sk = st[1]; a.q_sg = st[2];
  a.k_sb = st[3]; a.k_sk = st[4]; a.k_sc = st[5];
  a.v_sb = st[6]; a.v_sk = st[7]; a.v_sc = st[8];
  a.o_sb = st[9]; a.o_sk = st[10]; a.o_sg = st[11];
  a.K = K; a.G = G; a.valid = valid; a.chunk = chunk; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_t<float>(a, hd, B * K, splits, s);
  else if (dtype == 1) err = launch_t<__nv_bfloat16>(a, hd, B * K, splits, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
