// One-token flash decode over a KV cache for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel repro/kernels/decode_attention.py
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
// is 67 MB of K and V) and does ~4 FLOPs per byte, so it is bound by bytes.
// Its design, to keep the card's memory busy:
//
//   * the cache is read in place in the model's (B, C, K, hd) layout through
//     element strides; the reference's wrapper transposes the whole cache to
//     (B*K, C, hd) on every call, which would triple the bytes moved;
//   * B*K rows alone (64 at qwen3 batch 8) would occupy half the 132 SMs, so
//     the live slots of each row are split over a cluster of 8 blocks (a
//     Hopper thread-block cluster); each block reduces its share to one
//     (max, sum, accumulator) per query head, and the cluster's first block
//     combines the 8 partial states through distributed shared memory. One
//     launch, no scratch in device memory;
//   * in a block, each of 4 warps walks batches of 4 slots: every lane loads
//     hd/32 contiguous elements of 4 keys and 4 values (8-byte loads at
//     hd 128 in bf16; at hd 112, 4 elements on 28 lanes) before any
//     arithmetic, so many loads are in flight;
//     the dot products reduce over the warp with shuffles;
//   * all G query heads of a kv head (up to 4 per block; more go to further
//     blocks) share each loaded key and value, as the Pallas kernel shares
//     its tile.
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
constexpr int kSplit = 8;                   // blocks per cluster (cache split)
constexpr int kWarps = 4;
constexpr int kSlots = 4;                   // slots per warp per batch

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides: q and o over (B, K, G), k and v over (B, K, C); the
  // head_dim stride is 1
  long long q_sb, q_sk, q_sg;
  long long k_sb, k_sk, k_sc;
  long long v_sb, v_sk, v_sc;
  long long o_sb, o_sk, o_sg;
  int K, G, valid;
  float scale;
};

// N consecutive elements -> fp32, in 16-, 8-, 4- or 2-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(p + i);
        out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
      }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const float2 x = *reinterpret_cast<const float2*>(p + i);
        out[i] = x.x; out[i + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = p[i];
    }
  } else {
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
        const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          out[i + 2 * j] = f.x;
          out[i + 2 * j + 1] = f.y;
        }
      }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p + i));
        out[i] = f.x; out[i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_one(T* p, float x) {
  if constexpr (std::is_same<T, float>::value) *p = x;
  else *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// elements of a head row per lane: the fewest, at least HD / 32, that split
// the row into whole lanes (hd 112: 4 elements on each of 28 lanes). Lanes
// past HD / EPL own nothing: their q, keys and values are zeros, so they add
// exact zeros to every shuffle sum and write no output.
__host__ __device__ constexpr int elems_per_lane(int hd) {
  int e = (hd + 31) / 32;
  while (hd % e) ++e;
  return e;
}

// grid (kSplit, ceil(G / GC), B * K); the cluster spans the kSplit blocks of
// one (row, head group)
template <typename T, int HD, int GC>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kWarps * 32)
decode_kernel(const DecodeArgs a) {
  constexpr int EPL = elems_per_lane(HD);
  constexpr int ACTIVE = HD / EPL;             // lanes that own elements
  static_assert(ACTIVE <= 32 && ACTIVE * EPL == HD, "a head row per warp");
  __shared__ float part_acc[kWarps][GC][HD];
  __shared__ float part_m[kWarps][GC], part_l[kWarps][GC];
  __shared__ float blk_acc[GC][HD];
  __shared__ float blk_m[GC], blk_l[GC];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int g0 = blockIdx.y * GC;
  const int b = blockIdx.z / a.K, kh = blockIdx.z % a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool owns = lane < ACTIVE;
  const int d0 = lane * EPL;

  // this block's share of the live slots
  const int chunk = (a.valid + kSplit - 1) / kSplit;
  const int c0 = min(rank * chunk, a.valid);
  const int c1 = min(c0 + chunk, a.valid);

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sk + d0;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sk + d0;

  float q[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (owns && g0 + g < a.G) {
      load_row<T, EPL>(static_cast<const T*>(a.q) + b * a.q_sb +
                       kh * a.q_sk + (g0 + g) * a.q_sg + d0, q[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[g][e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[g][e] = 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // every batch a warp takes starts below c1, so it holds a live slot and
  // its masked slots weigh exp(NEG_INF - m) = 0 exactly
  for (int base = c0 + warp * kSlots; base < c1; base += kWarps * kSlots) {
    float kf[kSlots][EPL], vf[kSlots][EPL];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (owns && base + s < c1) {
        load_row<T, EPL>(kp + (long long)(base + s) * a.k_sc, kf[s]);
        load_row<T, EPL>(vp + (long long)(base + s) * a.v_sc, vf[s]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[s][e] = vf[s][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float sc[kSlots];
      float mx = kNegInf;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(q[g][e], kf[s][e], dot);
        dot = warp_sum(dot);
        sc[s] = base + s < c1 ? dot : kNegInf;
        mx = fmaxf(mx, sc[s]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float p = expf(sc[s] - m_new);
        ps += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[s][e], acc[g][e]);
      }
      l[g] = l[g] * corr + ps;
      m[g] = m_new;
    }
  }

  // combine the warps of this block
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (owns)
#pragma unroll
      for (int e = 0; e < EPL; ++e) part_acc[warp][g][d0 + e] = acc[g][e];
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GC * HD; i += kWarps * 32) {
    const int g = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part_m[w][g]);
    float sum = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(part_m[w][g] - mx);
      sum += part_acc[w][g][d] * f;
      ls += part_l[w][g] * f;
    }
    blk_acc[g][d] = sum;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = ls;
    }
  }

  // combine the cluster's blocks in its first block
  cluster.sync();
  if (rank == 0) {
    T* op = static_cast<T*>(a.o) + b * a.o_sb + kh * a.o_sk;
    for (int i = threadIdx.x; i < GC * HD; i += kWarps * 32) {
      const int g = i / HD, d = i % HD;
      if (g0 + g >= a.G) continue;
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kSplit; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(&blk_m[0], r)[g]);
      float sum = 0.f, ls = 0.f;
#pragma unroll
      for (int r = 0; r < kSplit; ++r) {
        const float f = expf(cluster.map_shared_rank(&blk_m[0], r)[g] - mx);
        sum += cluster.map_shared_rank(&blk_acc[0][0], r)[g * HD + d] * f;
        ls += cluster.map_shared_rank(&blk_l[0], r)[g] * f;
      }
      store_one(op + (g0 + g) * a.o_sg + d, sum / fmaxf(ls, 1e-30f));
    }
  }
  cluster.sync();                    // keep every block's partials alive
}

template <typename T, int HD, int GC>
cudaError_t launch_gc(const DecodeArgs& a, int BK, cudaStream_t st) {
  const dim3 grid(kSplit, (a.G + GC - 1) / GC, BK);
  decode_kernel<T, HD, GC><<<grid, kWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const DecodeArgs& a, int BK, cudaStream_t st) {
  if (a.G == 1) return launch_gc<T, HD, 1>(a, BK, st);
  if (a.G == 2) return launch_gc<T, HD, 2>(a, BK, st);
  return launch_gc<T, HD, 4>(a, BK, st);
}

template <typename T>
cudaError_t launch_t(const DecodeArgs& a, int hd, int BK, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, BK, st);
    case 64: return launch_hd<T, 64>(a, BK, st);
    case 112: return launch_hd<T, 112>(a, BK, st);
    case 128: return launch_hd<T, 128>(a, BK, st);
    case 256: return launch_hd<T, 256>(a, BK, st);
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
// contiguous; slots [0, valid) are live. dtype 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns cudaGetLastError().
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, const long long* st, int B, int K, int G,
                            int hd, int valid, float scale, int dtype,
                            void* stream) {
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = st[0]; a.q_sk = st[1]; a.q_sg = st[2];
  a.k_sb = st[3]; a.k_sk = st[4]; a.k_sc = st[5];
  a.v_sb = st[6]; a.v_sk = st[7]; a.v_sc = st[8];
  a.o_sb = st[9]; a.o_sk = st[10]; a.o_sg = st[11];
  a.K = K; a.G = G; a.valid = valid; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_t<float>(a, hd, B * K, s);
  else if (dtype == 1) err = launch_t<__nv_bfloat16>(a, hd, B * K, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
