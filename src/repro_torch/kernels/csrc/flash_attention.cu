// Causal / sliding-window / bidirectional GQA flash prefill attention for
// Hopper (sm_90a).
//
// Port of the Pallas TPU kernel repro/kernels/flash_attention.py:40
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
// What bounds it on the H100: at qwen3-0.6b's serving shape (B*K = 64,
// G = 2, S = 2048, hd = 128) the causal band is 1.375e11 FLOPs against
// ~0.2 GB of q/k/v/o, far above the card's ridge point, so it is bound by
// operations: 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak (gemma-7b's,
// B*K = 128, G = 1, hd = 256: 2.75e11 FLOPs, 0.278 ms). There are
// three routes behind one entry point, chosen by the wrapper
// (flash_attention.py::route) from the dtype and head_dim:
//
// bfloat16 at head_dim 64, 112, 128 and 256 (every served prefill):
//   flash_bf16_wgmma_kernel, on the tensor cores through wgmma.
//   * what bounds it: operations. The tensor cores issue 1.5x the band's
//     products (P.V runs twice, once for each bf16 part of the weights,
//     below) over whole tiles, so the floor is 1.5x the band's FLOPs at
//     the peak; the softmax's exp2f, max and conversions run on the other
//     pipes and must hide behind the products. The design keeps the tensor
//     cores fed: the only instruction that reaches the peak (wgmma), loads
//     that cost the consumers no instructions (TMA), and two consumer
//     warpgroups that take turns at the tensor cores, each running a
//     tile's softmax while the products of its last tile and of the other
//     warpgroup run.
//   * one block of 384 threads owns a (128-row q tile, kv-head row, group
//     head): warpgroup 0 is the producer, warpgroups 1 and 2 the consumers,
//     each owning 64 query rows. setmaxnreg moves registers from the
//     producer (24 a thread) to the consumers (240).
//   * kv tiles are 128 rows, but 80 at head_dim 256: there O alone takes
//     hd / 2 = 128 registers a consumer thread, and S and P's two parts
//     over 128 columns would take 128 more, past the 240; over 80 columns
//     they take 80 (208 in all). The ring holds as many stages as fit
//     beside q in the 227 KB a block may use: 4 at hd 64, 3 at 112 and
//     128, 2 at 256 (q 64 KB, a K or V stage 40 KB). Of 80-, 64- and
//     48-row tiles at 256, 80 ran fastest (PERF.md).
//   * the producer's one thread loads q once and then every K and V tile of
//     the block's band by TMA (cp.async.bulk.tensor) straight from the
//     model's (B, S, K, G, hd) / (B, S, K, hd) layout: the host builds one
//     5-D (q) or 4-D (k, v) tensor map over the element strides. A tile
//     lands as 64-column blocks with the 128-byte swizzle that wgmma reads;
//     rows past seq and columns past head_dim (112 in a 128-column tile)
//     are zero-filled by the TMA unit. A stage has a full mbarrier (the
//     TMA's bytes) and an empty one (one arrival per consumer warp), freed
//     once its P.V has completed; in a ring of 2 stages (hd 256) K and V
//     have a pair each, and K is freed once its scores have completed, so
//     the next K loads while the last P.V runs (one pair for both costs
//     hd 112 and 128 2-3 % in a deeper ring: PERF.md);
//   * S = Q.K^T is wgmma m64n{bkv}k16 with both operands in shared memory
//     (K-major descriptors; the k16 steps advance 32 bytes inside a
//     swizzle atom; at hd 112 the seven steps stop short of the zero
//     columns). The online softmax runs on the accumulator registers: a
//     row's max reduces over the 4 lanes that share it, O is rescaled only
//     when some row of the warp raised its max, and masks are evaluated
//     only on tiles that cross the diagonal, the window's edge or the
//     ragged tail;
//   * O += P.V is wgmma m64n{hd}k16 with A from registers (m64n256k16 at
//     hd 256, the widest n wgmma takes): the weights are split straight
//     from the S accumulators (the accumulator layout of wgmma is its
//     register-A layout, row pairs of 8 columns) into two bf16 parts, hi =
//     bf16(p) and lo = bf16(p - hi), each multiplied by V: hi + lo is p to
//     2^-18, where one bf16 rounding (2^-9) put the served 2-layer model's
//     logits past the bf16 tolerance (PERF.md). V is the B operand read
//     MN-major through the descriptor's transpose bit. l sums the fp32
//     weights;
//   * a consumer issues tile j's S and tile j - 1's P.V together in its
//     turn (named barriers hand the turn between the two consumers), then
//     waits for S only: tile j's softmax overlaps the P.V. O is rescaled
//     and P rewritten once that P.V has completed. Registers: O (hd / 2),
//     S (bkv / 2) and P's two parts (bkv / 2) a thread, 0 bytes of spill
//     at 240.
//
// The scale is applied to the fp32 scores, folded with log2(e) into exp2f,
// so a masked score (NEG_INF) still underflows to exactly 0 once a row has
// a live key, and a wholly masked first tile (p = exp2(0) = 1) is wiped by
// corr = 0 at the next, as in the reference.
//
// bfloat16 at head_dim 16 (the reduced test configs):
//   flash_bf16_mma_kernel, the Ampere-style route: mma.sync m16n8k16,
//   ldmatrix and cp.async, 128-row q tiles of 4 warps, kv tiles of 64 rows
//   in a ring, the same softmax and the same hi + lo weights.
//
// float32 (the exact model checks): flash_f32_kernel, scalar fp32 FMAs on
//   the CUDA cores, to stay within 2e-5 of the plain version (TF32 would
//   not). One block of 256 threads owns a (64-row q tile, kv-head row,
//   group head); q, k and v are staged in shared memory (rows padded by 4
//   floats); each thread owns a 4 x (kv tile / 16) block of scores and 4
//   rows of the output in float4 columns 4 * (tx + 16 c) (at hd 112 the
//   second column exists for tx < 12 only: every use is guarded by
//   col < HD); row max and sum reduce over 16 lanes with shuffles.
//
// Every route issues q tiles heaviest first (the last causal tile has the
// most kv tiles), so the tail of the grid is short. The C entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_common.cuh"    // tensor maps, mbarriers and TMA loads

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, finite as in the reference

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

// kv tiles [j0, j1) that meet the band of the q tile starting at q0
__device__ __forceinline__ void kv_range(const FlashArgs& a, int q0, int bq,
                                         int bkv, int& j0, int& j1) {
  int hi = a.S;
  if (a.causal) hi = min(hi, q0 + bq);
  int lo = 0;
  if (a.window) lo = max(0, q0 - a.window + 1);
  j0 = lo / bkv;
  j1 = (hi + bkv - 1) / bkv;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                     // query rows per block

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
__host__ __device__ constexpr int kv_tile() { return HD >= 256 ? 32 : 64; }

template <int HD, int BKV>
constexpr int smem_floats() {
  return kBQ * (HD + 4) + BKV * (HD + 4) + BKV * HD + kBQ * (BKV + 4);
}

template <int HD, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const FlashArgs a) {
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

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb +
                    kh * a.q_sk + g * a.q_sg;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sk;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sk;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + kh * a.o_sk +
              g * a.o_sg;

  // the q tile, scaled, rows past seq zero
  for (int i = tid; i < kBQ * V4; i += kThreads) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = *reinterpret_cast<const float4*>(qp + (long long)(q0 + r) * a.q_ss +
                                           c);
      x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    }
    *reinterpret_cast<float4*>(sQ + r * QS + c) = x;
  }

  int j0, j1;
  kv_range(a, q0, kBQ, BKV, j0, j1);

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
        kx = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) *
                                              a.k_ss + c);
        vx = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) *
                                              a.v_ss + c);
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
        *reinterpret_cast<float4*>(op + (long long)qpos * a.o_ss + col) =
            make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                        acc[i][c][2] * inv, acc[i][c][3] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const FlashArgs& a, int G, int BK, cudaStream_t st) {
  constexpr int BKV = kv_tile<HD>();
  constexpr size_t smem = sizeof(float) * smem_floats<HD, BKV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_q = (a.S + kBQ - 1) / kBQ;
  flash_f32_kernel<HD, BKV><<<dim3(n_q, G, BK), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 at head_dim 16: tensor cores (mma.sync, ldmatrix, cp.async as
// inline PTX)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;                    // query rows per block

// m16 tiles (16 q rows) per warp (2, so each K and V fragment feeds two
// products), warps, kv rows per tile, ring stages, blocks per SM
template <int HD>
struct Cfg {
  static_assert(HD == 16, "the mma.sync route runs head_dim 16 only");
  static constexpr int MT = 2;
  static constexpr int WARPS = kBQ / (16 * MT);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BKV = 64;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = 2;
  // the q tile and STAGES K and V tiles, rows padded by 8 bf16
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (HD + 8) * (kBQ + 2 * STAGES * BKV);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (no bytes
// are read from src then)
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

// four 8x8 bf16 matrices from the shared-memory address `addr` (bytes)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one m16n8k16 tile, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 weights -> their bf16 pair `hi` (x in the low half) and the bf16
// pair of what rounding left out, `lo`: hi + lo is (x, y) to 2^-18 relative,
// so P.V = hi.V + lo.V keeps the fp32 weights of the reference
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&r);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::MIN_BLOCKS)
flash_bf16_mma_kernel(const FlashArgs a) {
  using bf16 = __nv_bfloat16;
  using C = Cfg<HD>;
  constexpr int MT = C::MT, BKV = C::BKV, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS;
  constexpr int RS = HD + 8;            // padded row stride, in bf16
  constexpr int CH = HD / 8;            // 16-byte chunks per row
  constexpr int KS = HD / 16;           // k steps of Q.K^T
  constexpr int NS = BKV / 8;           // n tiles of S
  constexpr int NO = HD / 8;            // n tiles of O
  constexpr int WR = 16 * MT;           // query rows per warp
  static_assert(HD % 16 == 0 && BKV % 16 == 0, "m16n8k16 tiling");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * RS;             // STAGES tiles of BKV rows
  bf16* sV = sK + STAGES * BKV * RS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int g = blockIdx.y;
  const int b = blockIdx.z / a.K, kh = blockIdx.z % a.K;
  const int q0 = qt * kBQ;
  const int S = a.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wq0 = q0 + WR * warp;       // this warp's first query row

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + kh * a.q_sk +
                   g * a.q_sg;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sk;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sk;
  bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + kh * a.o_sk + g * a.o_sg;

  int j0, j1;
  kv_range(a, q0, kBQ, BKV, j0, j1);

  auto load_kv = [&](int j, int stage) {
    const int k0 = j * BKV;
    bf16* dk = sK + stage * BKV * RS;
    bf16* dv = sV + stage * BKV * RS;
    // not unrolled: the copies' addresses are not worth registers that the
    // accumulators need
#pragma unroll 1
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < S;
      const long long row = in ? k0 + r : 0;
      cp_async16(dk + r * RS + c, kp + row * a.k_ss + c, in);
      cp_async16(dv + r * RS + c, vp + row * a.v_ss + c, in);
    }
  };

  // prologue: q with the first kv tile, then the next STAGES - 2
  for (int i = tid; i < kBQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < S;
    cp_async16(sQ + r * RS + c, qp + (in ? q0 + r : 0) * a.q_ss + c, in);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (j0 + t < j1) load_kv(j0 + t, t);
    cp_async_commit();
  }

  // ldmatrix addressing, in bytes of shared memory: lane l feeds row (l & 7)
  // of 8x8 matrix l >> 3
  const int lrow = lane & 7, lmat = lane >> 3;
  constexpr int RB = 2 * RS;            // row stride in bytes
  // Q (A, row-major): matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  const unsigned qa = smem_addr(sQ) + (WR * warp + (lmat & 1) * 8 + lrow) *
                      RB + (lmat >> 1) * 16;
  // K (B, col): n = kv row, k = head column; matrices (n 0-7: k lo, k hi),
  // (n 8-15: k lo, k hi)
  const unsigned ka = smem_addr(sK) + ((lmat >> 1) * 8 + lrow) * RB +
                      (lmat & 1) * 16;
  // V (B via .trans): k = kv row, n = head column
  const unsigned va = smem_addr(sV) + ((lmat & 1) * 8 + lrow) * RB +
                      (lmat >> 1) * 16;

  // this lane's accumulator rows (+ 16 mt, + 8 h) and first column
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)

  unsigned qf[MT][KS][4];                // the warp's q rows, loaded once
  float o[MT][NO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    const int it = j - j0;
    cp_async_wait<STAGES - 2>();        // tile j (and q) has landed
    __syncthreads();                    // ... for every thread; tile j - 1 is
                                        // consumed, so its stage is free
    if (j + STAGES - 1 < j1)
      load_kv(j + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[mt][kk], qa + 16 * mt * RB + 32 * kk);
    }
    const int k0 = j * BKV;
    // a tile wholly outside this warp's rows' band adds nothing
    if ((a.causal && k0 > wq0 + WR - 1) ||
        (a.window && k0 + BKV - 1 <= wq0 - a.window))
      continue;
    const unsigned stage = (it % STAGES) * BKV * RB;

    // S = Q . K^T, fp32
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ka + stage + 16 * np * RB + 32 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
          mma(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
        }
      }
    }

    // masks, only where the tile crosses the diagonal, the window's edge or
    // the ragged tail
    if (k0 + BKV > S || (a.causal && k0 + BKV - 1 > wq0) ||
        (a.window && k0 <= wq0 + WR - 1 - a.window)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + c0 + (e & 1);
            const int qpos = wq0 + 16 * mt + r0 + 8 * (e >> 1);
            bool ok = kpos < S;
            if (a.causal) ok = ok && kpos <= qpos;
            if (a.window) ok = ok && kpos > qpos - a.window;
            if (!ok) s[mt][n][e] = kNegInf;
          }
    }

    // online softmax: rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3) of each m
    // tile; a row's max reduces over the 4 lanes that hold it
    float corr[MT][2];
    bool moved = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * h], s[mt][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][h], mx);
        corr[mt][h] = exp2f((m[mt][h] - m_new) * sl2);
        moved = moved || m_new != m[mt][h];
        const float mb = m_new * sl2;
        m[mt][h] = m_new;
        l[mt][h] *= corr[mt][h];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[mt][n][2 * h] = exp2f(fmaf(s[mt][n][2 * h], sl2, -mb));
          s[mt][n][2 * h + 1] = exp2f(fmaf(s[mt][n][2 * h + 1], sl2, -mb));
          l[mt][h] += s[mt][n][2 * h] + s[mt][n][2 * h + 1];
        }
      }
    // rescale O only when some row of the warp raised its max (corr is
    // exactly 1 otherwise)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mt][n][0] *= corr[mt][0];
          o[mt][n][1] *= corr[mt][0];
          o[mt][n][2] *= corr[mt][1];
          o[mt][n][3] *= corr[mt][1];
        }
    }

    // O += P . V, P split into bf16 hi and lo parts straight from the score
    // registers (the C layout of m16n8k16 is its A layout): two products
    // per V fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      unsigned ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][0], pl[mt][0]);
        split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][1], pl[mt][1]);
        split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][2],
                   pl[mt][2]);
        split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][3],
                   pl[mt][3]);
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, va + stage + 16 * kk * RB + 32 * np);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * np], ph[mt], bv[0], bv[1]);
          mma(o[mt][2 * np + 1], ph[mt], bv[2], bv[3]);
          mma(o[mt][2 * np], pl[mt], bv[0], bv[1]);
          mma(o[mt][2 * np + 1], pl[mt], bv[2], bv[3]);
        }
      }
    }
  }

  // epilogue: the row sums over the 4 lanes of a row, divide, round, store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lr = l[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qpos = wq0 + 16 * mt + r0 + 8 * h;
      if (qpos >= S) continue;
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      bf16* orow = op + (long long)qpos * a.o_ss + c0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][2 * h] * inv,
                                  o[mt][n][2 * h + 1] * inv);
    }
}

template <int HD>
cudaError_t launch(const FlashArgs& a, int G, int BK, cudaStream_t st) {
  using C = Cfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q = (a.S + kBQ - 1) / kBQ;
  flash_bf16_mma_kernel<HD><<<dim3(n_q, G, BK), C::THREADS, C::SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bfloat16 at head_dim 64, 112, 128 and 256: wgmma, TMA and mbarriers, warp
// specialised (inline PTX)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBQ = 128;      // query rows per block: two consumers of 64
constexpr int kThreads = 384; // the producer warpgroup and two consumers
constexpr int kConsumerWarps = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// per head_dim: kv rows per tile (the n of S = Q.K^T: 128, but 80 at
// head_dim 256, where O takes 128 registers a consumer thread; see the top
// of the file), 64-column blocks of a tile (the 128-byte swizzle atom is 64
// bf16 wide; hd 112 takes two, the second zero-filled past column 112), k16
// steps of Q.K^T, shared-memory bytes of q and of one K (or V) stage, the
// ring's stages (as many as fit beside q, at most 4: 4 at hd 64, 3 at 112
// and 128, 2 at 256), whether K and V of a stage have barriers of their own
// (`SPLIT`, in a ring of 2 stages) and the bytes in all (the 1024-byte
// alignment the swizzle needs, the tiles, then the q barrier and each
// stage's four: K and V landed, K and V freed; a ring of 3 or more uses
// the K pair for both)
template <int HD>
struct Cfg {
  static constexpr int BKV = HD > 128 ? 80 : 128;
  static constexpr int NB = (HD + 63) / 64;
  static constexpr int KS = HD / 16;
  static constexpr int Q_BYTES = NB * kBQ * 128;
  static constexpr int KV_BYTES = NB * BKV * 128;
  static constexpr int FIT = (kSmemMax - 1024 - Q_BYTES - 8) /
                             (2 * KV_BYTES + 32);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr bool SPLIT = STAGES == 2;
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
  static_assert(BKV % 16 == 0 && STAGES >= 2 && SMEM <= kSmemMax,
                "a kv tile of 16-row steps and a ring of two stages or more");
};

using namespace tma;

// the accumulator operands of a wgmma: d[i .. i + 31] (WG_ACC8 gives eight)
#define WG_ACC32(i) \
  WG_ACC8(i), WG_ACC8(i + 8), WG_ACC8(i + 16), WG_ACC8(i + 24)

// d (m64 x nN, fp32) = [d +] A . B^T for N = 80 and 128 (the kv tiles),
// A and B bf16 K-major in shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0), WG_ACC8(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0), WG_ACC32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x nN, fp32) += A . B for N = 64, 112, 128 and 256 (the
// head_dims), A bf16 from registers, B bf16 MN-major in shared memory (the
// transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[56],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0), WG_ACC8(32), WG_ACC8(40), WG_ACC8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0), WG_ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0), WG_ACC32(32), WG_ACC32(64), WG_ACC32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_ACC32

// shared-memory layout of a block: q, then the ring's K and V stages (all
// 1024-aligned: the swizzle is a function of the address), then the q
// barrier and each stage's barriers
template <class C>
struct Smem {
  uint32_t q, k, v, qbar;
  __device__ explicit Smem(uint32_t base)
      : q(base), k(base + C::Q_BYTES), v(k + C::STAGES * C::KV_BYTES),
        qbar(v + C::STAGES * C::KV_BYTES) {}
  // stage s's K (V) tile has landed: the TMA's bytes
  __device__ uint32_t full_k(int s) const { return qbar + 8u * (1 + s); }
  __device__ uint32_t full_v(int s) const {
    return C::SPLIT ? qbar + 8u * (1 + C::STAGES + s) : full_k(s);
  }
  // every consumer warp is done with stage s's K (V) tile
  __device__ uint32_t empty_k(int s) const {
    return qbar + 8u * (1 + 2 * C::STAGES + s);
  }
  __device__ uint32_t empty_v(int s) const {
    return C::SPLIT ? qbar + 8u * (1 + 3 * C::STAGES + s) : empty_k(s);
  }
};

// the producer's one thread: q, then K and V tile j of the band into stage
// (j - j0) % STAGES once every consumer warp has freed that stage: with
// `SPLIT`, K once the scores of the tile there are done and V once its
// P.V is, so in a ring of 2 the next K loads while the last P.V runs; else
// both once its P.V is
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Smem<C>& sm, int q0, int g,
                                        int kh, int b, int j0, int j1) {
  mbar_expect_tx(sm.qbar, C::Q_BYTES);
  for (int c = 0; c < C::NB; ++c)
    tma_load_5d(sm.q + c * kBQ * 128, tq, sm.qbar, 64 * c, q0, g, kh, b);
  for (int j = j0; j < j1; ++j) {
    const int it = j - j0, s = it % C::STAGES;
    const uint32_t parity = (it / C::STAGES - 1) & 1;
    const uint32_t off = s * C::KV_BYTES;
    if (it >= C::STAGES) mbar_wait(sm.empty_k(s), parity);
    mbar_expect_tx(sm.full_k(s), C::SPLIT ? C::KV_BYTES : 2 * C::KV_BYTES);
    for (int c = 0; c < C::NB; ++c)
      tma_load_4d(sm.k + off + c * C::BKV * 128, tk, sm.full_k(s), 64 * c,
                  j * C::BKV, kh, b);
    if constexpr (C::SPLIT) {
      if (it >= C::STAGES) mbar_wait(sm.empty_v(s), parity);
      mbar_expect_tx(sm.full_v(s), C::KV_BYTES);
    }
    for (int c = 0; c < C::NB; ++c)
      tma_load_4d(sm.v + off + c * C::BKV * 128, tv, sm.full_v(s), 64 * c,
                  j * C::BKV, kh, b);
  }
}

// S = Q . K^T for one kv tile into `sc` (fp32), issued and committed as one
// wgmma group: KS k16 steps, each advancing 32 bytes inside the swizzle
// atom of q and of K
template <class C>
__device__ __forceinline__ void issue_s(float (&sc)[C::BKV / 2], uint32_t qa,
                                        uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(sc, desc(qa + (kk / 4) * kBQ * 128 + col, 16, 1024),
             desc(ks + (kk / 4) * C::BKV * 128 + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P . V for one kv tile, as one wgmma group: V's k16 step kk is its
// rows 16 kk .. 16 kk + 15, multiplied by the hi and then the lo part of P
template <class C, int R>
__device__ __forceinline__ void issue_pv(float (&o)[R],
                                         const unsigned (&ph)[C::BKV / 16][4],
                                         const unsigned (&pl)[C::BKV / 16][4],
                                         uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk) {
    const uint64_t dv = desc(vs + kk * 16 * 128, C::BKV * 128, 1024);
    wgmma_rs(o, ph[kk], dv);
    wgmma_rs(o, pl[kk], dv);
  }
  wgmma_commit();
}

// a consumer warpgroup: q rows wq0 .. wq0 + 63 of the block's tile; thread
// t holds rows r0 and r0 + 8 of them (accumulator index 4 n + 2 h + e: row
// r0 + 8 h, column 8 n + c0 + e).
//
// The two consumers take turns at the tensor cores (named barriers 1 and 2,
// warpgroup 0 first): in its turn a warpgroup issues tile j's scores and
// tile j - 1's P.V, then hands the turn over and runs tile j's softmax
// while the tensor cores multiply, first its own P.V, then the other
// warpgroup's products. Both consumers visit every tile of the block's
// band, so their turns pair up; a tile wholly outside a warpgroup's rows'
// band is all NEG_INF, and its weights are wiped by corr = 0 at the row's
// first live tile (or weigh exactly 0 after its last).
template <class C, int HD>
__device__ __forceinline__ void consume(const FlashArgs& a,
                                        const Smem<C>& sm, int cw, int t,
                                        int q0, int g, int kh, int b, int j0,
                                        int j1) {
  using bf16 = __nv_bfloat16;
  constexpr int STAGES = C::STAGES, BKV = C::BKV;
  constexpr int NS = BKV / 8;           // 8-column n tiles of S
  constexpr int NO = HD / 8;            // 8-column n tiles of O
  constexpr int PK = BKV / 16;          // k16 steps of P.V
  const int lane = t % 32;
  const int wq0 = q0 + 64 * cw;
  const int r0 = 16 * (t / 32) + (lane >> 2), c0 = 2 * (lane & 3);
  const int S = a.S;
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  const uint32_t qa = sm.q + cw * 64 * 128;
  auto stage = [&](int j) { return (j - j0) % STAGES; };
  auto parity = [&](int j) { return ((j - j0) / STAGES) & 1; };
  // tile j's K (V) is in its stage; this warp is done with it (without
  // `SPLIT` one barrier pair covers both: V has landed with K, and K is
  // freed with V)
  auto arrived_k = [&](int j) { mbar_wait(sm.full_k(stage(j)), parity(j)); };
  auto arrived_v = [&](int j) {
    if constexpr (C::SPLIT) mbar_wait(sm.full_v(stage(j)), parity(j));
  };
  auto release_k = [&](int j) {
    if constexpr (C::SPLIT)
      if (lane == 0) mbar_arrive(sm.empty_k(stage(j)));
  };
  auto release_v = [&](int j) {
    if (lane == 0) mbar_arrive(sm.empty_v(stage(j)));
  };
  // this warpgroup's turn at the tensor cores, and the hand-over (the last
  // of warpgroup 1 has no turn to pair with)
  auto my_turn = [&]() { bar_sync(1 + cw, 256); };
  auto hand_over = [&](bool last) {
    if (!(last && cw == 1)) bar_arrive(2 - cw, 256);
  };

  float o[HD / 2], sc[BKV / 2];
  unsigned ph[PK][4], pl[PK][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;

  // tile j's scores (complete in sc) -> its weights in ph, pl, with O
  // rescaled by the change of each row's max; first, where `wait_pv`,
  // tile j - 1's P.V must complete (O, ph and pl are its operands). Masks
  // only where the tile crosses the diagonal, the window's edge or the
  // ragged tail; a row's max reduces over the 4 lanes that hold it; O is
  // rescaled only when some row of the warp raised its max (corr is exactly
  // 1 otherwise)
  auto softmax = [&](int j, bool wait_pv) {
    const int k0 = j * BKV;
    if (k0 + BKV > S || (a.causal && k0 + BKV - 1 > wq0) ||
        (a.window && k0 <= wq0 + 63 - a.window)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + c0 + (e & 1);
          const int qpos = wq0 + r0 + 8 * (e >> 1);
          bool ok = kpos < S;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && kpos > qpos - a.window;
          if (!ok) sc[4 * n + e] = kNegInf;
        }
    }
    float corr[2];
    bool moved = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f((m[h] - m_new) * sl2);
      moved = moved || m_new != m[h];
      const float mb = m_new * sl2;
      m[h] = m_new;
      l[h] *= corr[h];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        sc[4 * n + 2 * h] = exp2f(fmaf(sc[4 * n + 2 * h], sl2, -mb));
        sc[4 * n + 2 * h + 1] = exp2f(fmaf(sc[4 * n + 2 * h + 1], sl2, -mb));
        l[h] += sc[4 * n + 2 * h] + sc[4 * n + 2 * h + 1];
      }
    }
    if (wait_pv) {
      wgmma_wait<0>();
      hold(o);
      hold(ph);
      hold(pl);
      release_v(j - 1);
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
    }
    // the weights as bf16 hi and lo parts in wgmma's register-A order: k16
    // step kk holds S's n tiles 2 kk (regs 0, 1) and 2 kk + 1 (regs 2, 3)
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tc::split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], ph[kk][e],
                       pl[kk][e]);
  };

  if (cw == 1) bar_arrive(1, 256);     // warpgroup 0 takes the first turn
  mbar_wait(sm.qbar, 0);
  arrived_k(j0);
  my_turn();
  issue_s<C>(sc, qa, sm.k + stage(j0) * C::KV_BYTES);
  hand_over(false);
  wgmma_wait<0>();
  hold(sc);
  release_k(j0);
  softmax(j0, false);
  for (int j = j0 + 1; j < j1; ++j) {
    arrived_k(j);
    arrived_v(j - 1);
    my_turn();
    issue_s<C>(sc, qa, sm.k + stage(j) * C::KV_BYTES);
    issue_pv<C>(o, ph, pl, sm.v + stage(j - 1) * C::KV_BYTES);
    hand_over(false);
    wgmma_wait<1>();                    // S of tile j (P.V of j - 1 runs on)
    hold(sc);
    release_k(j);
    softmax(j, true);
  }
  arrived_v(j1 - 1);
  my_turn();
  issue_pv<C>(o, ph, pl, sm.v + stage(j1 - 1) * C::KV_BYTES);
  hand_over(true);
  wgmma_wait<0>();
  hold(o);
  hold(ph);
  hold(pl);
  release_v(j1 - 1);

  // epilogue: the row sums over the 4 lanes of a row, divide, round, store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qpos = wq0 + r0 + 8 * h;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    bf16* orow = static_cast<bf16*>(a.o) + b * a.o_sb + kh * a.o_sk +
                 g * a.o_sg + (long long)qpos * a.o_ss + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] * inv,
                                o[4 * n + 2 * h + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const FlashArgs a) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<C> sm((smem_addr(smem_raw) + 1023u) & ~1023u);
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int g = blockIdx.y;
  const int b = blockIdx.z / a.K, kh = blockIdx.z % a.K;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  int j0, j1;
  kv_range(a, q0, kBQ, C::BKV, j0, j1);

  if (tid == 0) {
    mbar_init(sm.qbar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.empty_k(s), kConsumerWarps);
      if (C::SPLIT) {
        mbar_init(sm.full_v(s), 1);
        mbar_init(sm.empty_v(s), kConsumerWarps);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the two roles never reconverge (setmaxnreg holds for each to its end)
  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) produce<C>(&tq, &tk, &tv, sm, q0, g, kh, b, j0, j1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<C, HD>(a, sm, tid / 128 - 1, tid % 128, q0, g, kh, b, j0, j1);
  }
}

template <int HD>
cudaError_t launch(const FlashArgs& a, int B, int G, cudaStream_t st) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  const long long qd[5] = {HD, a.S, G, a.K, B};
  const long long qs[4] = {a.q_ss, a.q_sg, a.q_sk, a.q_sb};
  const long long kd[4] = {HD, a.S, a.K, B};
  const long long ks[3] = {a.k_ss, a.k_sk, a.k_sb};
  const long long vs[3] = {a.v_ss, a.v_sk, a.v_sb};
  // bf16 boxes of 64 columns x 128 q rows (C::BKV kv rows) with the
  // 128-byte swizzle wgmma reads
  const cuuint32_t qbox[5] = {64, kBQ, 1, 1, 1};
  const cuuint32_t kvbox[4] = {64, C::BKV, 1, 1};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tq, bf16, 2, a.q, 5, qd, qs, qbox, sw) ||
      !tensor_map(&tk, bf16, 2, a.k, 4, kd, ks, kvbox, sw) ||
      !tensor_map(&tv, bf16, 2, a.v, 4, kd, vs, kvbox, sw))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q = (a.S + kBQ - 1) / kBQ;
  flash_bf16_wgmma_kernel<HD>
      <<<dim3(n_q, G, B * a.K), kThreads, C::SMEM, st>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace wg

// routes (flash_attention.py::ROUTES): 0 float32 on the CUDA cores, 1 bf16
// mma.sync (head_dim 16), 2 bf16 wgmma (head_dim 64, 112, 128, 256)
template <int HD>
constexpr int bf16_route() { return HD == 16 ? 1 : 2; }

template <int HD>
cudaError_t launch_hd(const FlashArgs& a, int route, int B, int G,
                      cudaStream_t st) {
  if (route == 0) return f32::launch<HD>(a, G, B * a.K, st);
  if (route != bf16_route<HD>()) return cudaErrorInvalidValue;
  if constexpr (bf16_route<HD>() == 1) return tc::launch<HD>(a, G, B * a.K, st);
  else return wg::launch<HD>(a, B, G, st);
}

// the bf16 `route`'s query rows per block and kv rows per tile at HD into
// `t`; 0 where that route does not run at HD
template <int HD>
int tiles_hd(int route, int* t) {
  if (route != bf16_route<HD>()) return 0;
  if constexpr (bf16_route<HD>() == 1) {
    t[0] = tc::kBQ;
    t[1] = tc::Cfg<HD>::BKV;
  } else {
    t[0] = wg::kBQ;
    t[1] = wg::Cfg<HD>::BKV;
  }
  return 1;
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// the dynamic shared memory the wgmma route launches with at `hd`, in bytes
// (0 where the route does not run)
int flash_attention_wgmma_smem(int hd) {
  switch (hd) {
    case 64: return wg::Cfg<64>::SMEM;
    case 112: return wg::Cfg<112>::SMEM;
    case 128: return wg::Cfg<128>::SMEM;
    case 256: return wg::Cfg<256>::SMEM;
    default: return 0;
  }
}

// the tiles of bf16 route `route` (1 or 2) at `hd` into `tiles` (query rows
// per block, kv rows per tile), as flash_attention.py::tile_geometry must
// give them; returns 0 where that route does not run at `hd`
int flash_attention_tiles(int hd, int route, int* tiles) {
  switch (hd) {
    case 16: return tiles_hd<16>(route, tiles);
    case 64: return tiles_hd<64>(route, tiles);
    case 112: return tiles_hd<112>(route, tiles);
    case 128: return tiles_hd<128>(route, tiles);
    case 256: return tiles_hd<256>(route, tiles);
    default: return 0;
  }
}

// q, o: (B, K, G, S, hd) and k, v: (B, K, S, hd) addressed through the 14
// element strides in `st` (q b,k,g,s; k b,k,s; v b,k,s; o b,k,g,s); head_dim
// contiguous. `route` as launch_hd's; float32 tensors for route 0, bfloat16
// for 1 and 2. Launches on `stream` and returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* st, int B, int K, int G,
                           int S, int hd, int causal, int window, float scale,
                           int route, void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = st[0]; a.q_sk = st[1]; a.q_sg = st[2]; a.q_ss = st[3];
  a.k_sb = st[4]; a.k_sk = st[5]; a.k_ss = st[6];
  a.v_sb = st[7]; a.v_sk = st[8]; a.v_ss = st[9];
  a.o_sb = st[10]; a.o_sk = st[11]; a.o_sg = st[12]; a.o_ss = st[13];
  a.K = K; a.S = S; a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_hd<16>(a, route, B, G, s); break;
    case 64: err = launch_hd<64>(a, route, B, G, s); break;
    case 112: err = launch_hd<112>(a, route, B, G, s); break;
    case 128: err = launch_hd<128>(a, route, B, G, s); break;
    case 256: err = launch_hd<256>(a, route, B, G, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
