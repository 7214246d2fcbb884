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
// 0.020 ms at 3.35 TB/s. The design keeps every SM streaming and keeps the
// work beside the stream small:
//
//   * an even split over the SMs: the live work, (row, head group) x tiles
//     of TS slots over [0, valid), is N tiles in a row-major order, and
//     block i of the grid's nb takes tiles [i N / nb, (i + 1) N / nb). The
//     wrapper sets nb to the device's SMs times the blocks that fit one, so
//     every block streams the same bytes (to one tile) whatever B*K, G and
//     valid are. A block's range may start or end inside a row;
//   * TMA into an mbarrier ring: one producer thread loads each tile's K
//     and V with cp.async.bulk.tensor through 4-D tensor maps over the
//     model's cache read in place, (hd, slots, K, B) with its element
//     strides, into a ring of as many stages as fit two blocks an SM (three
//     at hd 128 in bf16), guarded by a full mbarrier (the TMA's bytes) and
//     an empty one (one arrival per consumer warp). The maps' slot extent
//     is `valid`: a tile's rows past it are zero filled by the TMA unit,
//     never fetched, and masked by index;
//   * no block-wide barrier in the loop: 4 consumer warps wait only on the
//     ring; each owns a share of every tile's slots and keeps its (m, l,
//     acc) for each query head of its group in registers. In bfloat16
//     (every served decode) a warp's share goes through the tensor cores
//     (MmaWarp: mma.sync, K and V by ldmatrix from TMA's swizzled boxes, P
//     as bf16 hi + lo parts): on the CUDA cores the arithmetic of a tile
//     took about as long as its bytes, and the ring waited on it. float32
//     (the exact checks) stays on the CUDA cores (CoreWarp: lanes over a
//     row's 16-byte chunks, the dot product reduced by xor shuffles);
//   * the merge across blocks: at the end of each row segment the warps
//     merge through shared memory (barriers over the consumers only, while
//     the producer loads on); a row wholly inside the block is written out,
//     a share of a row goes to a float32 workspace (two slots a block: its
//     first and its last segment). A second launch, decode_merge_kernel,
//     set up during the first by programmatic dependent launch and waiting
//     for the first grid's end, merges each shared row's states with weights
//     exp2(m_c - max m) and writes o (and on request each head's
//     log-sum-exp, which sequence-parallel decode needs). A merge in the
//     same launch, by the last block to bump a counter, cost more: its
//     fence and atomic sat at the kernel's tail.
//
// Scores are kept in log2 units (scaled by head_dim^-0.5 * log2(e)) so the
// softmax runs on the SFU's ex2. The C entry point launches on the
// caller's stream, allocates nothing (the wrapper owns the workspace), and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma_common.cuh"    // tensor maps, mbarriers and TMA loads

namespace {

using namespace tma;

constexpr float kNegInf = -1073741824.0f;  // -2^30, finite as in the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kTileBytes = 8192;            // K (or V) bytes a tile aims at
constexpr int kSmemBudget = 113 * 1024;     // two blocks an SM
constexpr int kSmemMax = 227 * 1024;        // one block an SM
constexpr int kMaxStages = 8;
constexpr int kMaxGrid = 1 << 15;           // blocks a launch at most

constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// a block's geometry for element type T, head_dim HD and GC query heads a
// group. float32 (CUDA cores): bytes of a slot's row, elements a 16-byte
// chunk, chunks a row, lanes reading a slot (LPS), chunks and values a
// lane, slots a warp step (SPW), slots a tile (TS), warp steps a tile.
// bfloat16 (tensor cores): tiles of 64 slots, 16 a warp, that land as NB
// boxes of BW columns whose rows of RP bytes TMA swizzles (128 bytes, or 32
// at head_dim 16) so that ldmatrix reads them free of bank conflicts; at
// head_dim 112 one box of whole 224-byte rows, unswizzled (two boxes cut
// each row into pieces that straddle 128-byte lines, and the stream slowed;
// ldmatrix then meets 2-way bank conflicts). Both: bytes of K (or V) a tile
// in shared memory, floats of an (m, l, acc) state, stages and
// shared-memory bytes (the swizzle's alignment, the K and V rings, the
// warps' merge scratch and the barriers), within two blocks an SM, or one
// where two stages would not fit
template <typename T, int HD, int GC>
struct Geo {
  static constexpr bool MMA = !std::is_same<T, float>::value;
  static constexpr int ROW = HD * static_cast<int>(sizeof(T));
  static constexpr int E = 16 / static_cast<int>(sizeof(T));
  static constexpr int CH = HD / E;
  static constexpr int LPS = CH >= 32 ? 32 : pow2_ceil(CH);
  static constexpr int NC = CH > 32 ? CH / 32 : 1;
  static constexpr int ACT = CH < 32 ? CH : 32;   // lanes that read a chunk
  static constexpr int VPL = NC * E;
  static constexpr int SPW = MMA ? 16 : 32 / LPS;
  static constexpr int TS = MMA ? 16 * kConsumerWarps
                            : pow2_floor(kTileBytes / ROW) < 256
                                ? pow2_floor(kTileBytes / ROW)
                                : 256;
  static constexpr int ITER = TS / (kConsumerWarps * SPW);
  static constexpr bool SWZ = ROW <= 128 || ROW % 128 == 0;
  static constexpr int BW = !SWZ ? HD : HD < 64 ? HD : 64;
  static constexpr int RP = BW * static_cast<int>(sizeof(T));
  static constexpr int NB = (HD + BW - 1) / BW;
  static constexpr int TILE = MMA ? NB * TS * RP : TS * ROW;
  static constexpr int ALIGN = MMA ? 1024 : 128;
  static constexpr int PART = GC * (HD + 2);      // floats of (m, l, acc)
  static constexpr int SCRATCH = kConsumerWarps * PART * 4;
  static constexpr int fit(int budget) {
    return (budget - ALIGN - SCRATCH - 16 * kMaxStages) / (2 * TILE);
  }
  static constexpr int FIT = fit(kSmemBudget) >= 2 ? fit(kSmemBudget)
                                                   : fit(kSmemMax);
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int SMEM = ALIGN + 2 * STAGES * TILE + SCRATCH +
                              16 * STAGES;
  // ptxas aims a kernel of 160 threads at 128 registers (three blocks an
  // SM) on its own, and bf16 at head_dim 112 with 8 heads a group then
  // spills; asking for the two blocks an SM the shared memory allows lets
  // it take the few more it needs. Elsewhere no hint: a bound of two made
  // the served instances slower, and head_dim 256 needs ~250 registers
  static constexpr int MIN_BLOCKS = MMA && GC == 8 && HD <= 128 ? 2 : 0;
  static_assert(HD % E == 0 && (CH <= 32 || CH % 32 == 0), "head_dim");
  static_assert(ITER >= 1 && STAGES >= 2 && TS <= 256, "tile");
  static_assert(!MMA || (HD % 16 == 0 && RP % 16 == 0), "box");
};

struct DecodeArgs {
  const void* q;
  void* o;
  float* lse;   // (B, K, G) contiguous float32, or null
  float* ws;    // nb x 2 partial states of Geo::PART floats
  // element strides of q and o over (B, K, G); the head_dim stride is 1
  long long q_sb, q_sk, q_sg;
  long long o_sb, o_sk, o_sg;
  int B, K, G, NG, valid, T;   // NG head groups a row, T tiles a row
  // N tiles in all (B * K * NG * T, < 2^31) over nb blocks (<= 2^15):
  // N = tq * nb + tr, so block i's first tile i N / nb needs no 64-bit
  // division (a call, and spills, on the card)
  int N, nb, tq, tr;
  float qscale;             // head_dim^-0.5 * log2(e)
};

// the `NC` 16-byte chunks a lane reads of a float32 row: chunks cl,
// cl + 32, ...; zeros for a lane past the row's chunks
template <int NC>
__device__ __forceinline__ void load_chunks(const float* row, int cl,
                                            bool active, float* out) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 x = active
        ? *reinterpret_cast<const float4*>(row + (cl + 32 * c) * 4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    out[c * 4] = x.x; out[c * 4 + 1] = x.y;
    out[c * 4 + 2] = x.z; out[c * 4 + 3] = x.w;
  }
}

template <typename T>
__device__ __forceinline__ void store_one(T* p, float x) {
  if constexpr (std::is_same<T, float>::value) *p = x;
  else *p = __float2bfloat16_rn(x);
}

// 2^x on the SFU alone (exp2f adds a fix-up for subnormal results, which
// weigh nothing here); ex2(NEG_INF - m) is exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a barrier over the consumer warps only (the producer never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// the first tile of block `i`: i N / nb = i tq + i tr / nb
__device__ __forceinline__ int first_tile(const DecodeArgs& a, int i) {
  return i * a.tq + i * a.tr / a.nb;
}

// the block that holds tile `x`: a float estimate, then exact steps
__device__ __forceinline__ int block_of(const DecodeArgs& a, int x) {
  int b = min(a.nb - 1, static_cast<int>(__fdividef(
                            static_cast<float>(x), static_cast<float>(a.N)) *
                            a.nb));
  while (b > 0 && first_tile(a, b) > x) --b;
  while (b + 1 < a.nb && first_tile(a, b + 1) <= x) ++b;
  return b;
}

// the consumer warps' (m, l, acc) states in shared memory for one head, at
// `st` + w * stride, merged at column d with weights exp2(m_w - max m):
// (acc, l, max m)
__device__ __forceinline__ float3 merge_warps(const float* st, int stride,
                                              int d) {
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) mx = fmaxf(mx, st[w * stride]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) {
    const float f = ex2(st[w * stride] - mx);
    den = fmaf(f, st[w * stride + 1], den);
    num = fmaf(f, st[w * stride + 2 + d], num);
  }
  return make_float3(num, den, mx);
}

template <typename T>
__device__ __forceinline__ void write_out(const DecodeArgs& a, int bk, int h,
                                          int d, float3 r) {
  const int b = bk / a.K, kh = bk % a.K;
  // the division's approximate form (2 ulp, l in [1e-30, valid]) is
  // inline: the IEEE one calls a slow path, and the call spills
  store_one(static_cast<T*>(a.o) + b * a.o_sb + kh * a.o_sk + h * a.o_sg + d,
            __fdividef(r.x, fmaxf(r.y, 1e-30f)));
  if (a.lse != nullptr && d == 0)
    a.lse[static_cast<long long>(bk) * a.G + h] = r.z * kLn2 + logf(r.y);
}

// a float32 consumer warp on the CUDA cores: lane `cl` of slot group `grp`
// reads chunks cl, cl + 32, ... of the rows of its slots (slot j of a tile
// is warp (j / SPW) % 4's) and keeps (m, l, acc) for each head of the group
template <int HD, int GC>
struct CoreWarp {
  using L = Geo<float, HD, GC>;
  static constexpr int SPW = L::SPW, LPS = L::LPS, VPL = L::VPL;
  static constexpr int ITER = L::ITER;
  const int warp, lane, grp, cl;
  const bool active;
  float qf[GC][VPL], acc[GC][VPL], m[GC], l[GC];

  __device__ CoreWarp(int w, int ln)
      : warp(w), lane(ln), grp(ln / LPS), cl(ln % LPS), active(cl < L::ACT) {}

  // a new row segment: the scaled q of heads g0.. (zeros past G), empty
  // states
  __device__ void begin(const float* qp, long long q_sg, int g0, int G,
                        float qscale) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      load_chunks<L::NC>(qp + (g0 + g) * q_sg, cl, active && g0 + g < G,
                         qf[g]);
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        qf[g][e] *= qscale;
        acc[g][e] = 0.f;
      }
      m[g] = kNegInf;
      l[g] = 0.f;
    }
  }

  // one tile of K rows at `tk` and V rows at `tv` (dense, as TMA wrote
  // them), `live` >= 1 of its slots before valid
  __device__ void tile(const float* tk, const float* tv, int live) {
    // scores of the warp's slots: partial dots over the lane's chunks,
    // summed over the slot's LPS lanes
    float sc[GC][ITER];
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int j = (i * kConsumerWarps + warp) * SPW + grp;
      float kf[VPL];
      load_chunks<L::NC>(tk + j * HD, cl, active, kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < VPL; e += 2) {
          d0 = fmaf(qf[g][e], kf[e], d0);
          d1 = fmaf(qf[g][e + 1], kf[e + 1], d1);
        }
        sc[g][i] = d0 + d1;
      }
    }
#pragma unroll
    for (int off = 1; off < LPS; off <<= 1)
#pragma unroll
      for (int i = 0; i < ITER; ++i)
#pragma unroll
        for (int g = 0; g < GC; ++g)
          sc[g][i] += __shfl_xor_sync(0xffffffffu, sc[g][i], off);

    // one max per head over the warp's slots; rescale once a tile
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int j = (i * kConsumerWarps + warp) * SPW + grp;
        if (j >= live) sc[g][i] = kNegInf;
        mx = fmaxf(mx, sc[g][i]);
      }
#pragma unroll
      for (int off = LPS; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[g], mx);
      const float corr = ex2(m[g] - mn);
      m[g] = mn;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[g][e] *= corr;
    }

    // P.V over the warp's slots; dead slots weigh 0
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int j = (i * kConsumerWarps + warp) * SPW + grp;
      float vf[VPL];
      load_chunks<L::NC>(tv + j * HD, cl, active, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = j < live ? ex2(sc[g][i] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // the warp's state into its scratch: (m, l, acc) for each head, its slot
  // groups summed first
  __device__ void store(float* scr) {
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
        for (int e = 0; e < VPL; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
    if (grp != 0) return;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float* st = scr + (warp * GC + g) * (HD + 2);
      if (lane == 0) {
        st[0] = m[g];
        st[1] = l[g];
      }
      if (active)
#pragma unroll
        for (int c = 0; c < L::NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[2 + (cl + 32 * c) * 4 + e] = acc[g][c * 4 + e];
    }
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// c += A B for a bf16 m16n8k16 product whose A rows 8..15 are zero: a0, a2
// are A's (row lane / 4, columns 2 (lane % 4) .. +1 and +8 .. +9); c holds
// the product's rows 0..7 (columns 2 (lane % 4) .. +1): rows 8..15 are
// zero and are not kept
__device__ __forceinline__ void mma_bf16(float (&c)[2], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  float z2, z3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %5}, {%7, %8}, {%0, %1, %9, %9};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(z2), "=f"(z3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// a bfloat16 consumer warp on the tensor cores: S = q K^T for its 16 slots
// of a tile (two n8 tiles over head_dim / 16 k16 steps, the query heads as
// A's rows 0..7, rows 8..15 zero), the online softmax on S's fragments
// (row g = lane / 4: a quad's max, one rescale of O a tile, skipped when no
// row's max moved), then O += P V with P split into bf16 hi + lo parts
// (p = hi + lo to 2^-18; one bf16 rounding of P is what B3's bf16 model
// check refused) as A from registers and V through ldmatrix.trans. K and V
// are read from TMA's swizzled boxes: the 16-byte chunk c of row r of a box
// sits at c ^ (r & 7) (rows of 128 bytes) or c ^ ((r >> 2) & 1) (32)
template <int HD, int GC>
struct MmaWarp {
  using L = Geo<__nv_bfloat16, HD, GC>;
  static constexpr int KS = HD / 16, NT = HD / 8, TS = L::TS, RP = L::RP;
  static constexpr int BW = L::BW;
  const int warp, lane;
  uint32_t kofs, vofs;        // this lane's ldmatrix row, unswizzled
  int kx, vx, ksel, vsel;     // its swizzle and its matrix's 8-column half
  uint32_t qa[KS][2];
  float o[NT][2], m, l;

  static __device__ int swz(int row) {
    return !L::SWZ ? 0 : RP == 128 ? (row & 7) : ((row >> 2) & 1);
  }

  __device__ MmaWarp(int w, int ln) : warp(w), lane(ln) {
    const int mi = ln >> 3, rr = ln & 7;
    const int krow = w * 16 + (mi >> 1) * 8 + rr;   // x4: n8 tile, k half
    const int vrow = w * 16 + (mi & 1) * 8 + rr;    // x4.trans: k half, n8
    kofs = krow * RP;
    vofs = vrow * RP;
    kx = swz(krow);
    vx = swz(vrow);
    ksel = mi & 1;
    vsel = mi >> 1;
  }

  __device__ void begin(const __nv_bfloat16* qp, long long q_sg, int g0,
                        int G) {
    const int g = lane >> 2, c = lane & 3;
    const bool real = g < GC && g0 + g < G;
    const __nv_bfloat16* qr = qp + (g0 + (real ? g : 0)) * q_sg + 2 * c;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = real ? *reinterpret_cast<const uint32_t*>(qr + 16 * ks)
                       : 0u;
      qa[ks][1] = real ? *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8)
                       : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = 0.f;
    m = kNegInf;
    l = 0.f;
  }

  // the shared-memory address of column chunk `chunk8` (8 columns) of this
  // lane's row in a stage at `st`
  static __device__ uint32_t at(uint32_t st, uint32_t ofs, int x,
                                int chunk8) {
    const int cb = chunk8 / (BW / 8), c = chunk8 % (BW / 8);
    return st + cb * TS * RP + ofs + ((c ^ x) << 4);
  }

  __device__ void tile(uint32_t tk, uint32_t tv, int live, float qscale) {
    float sacc[2][2] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, at(tk, kofs, kx, 2 * ks + ksel));
      mma_bf16(sacc[0], qa[ks][0], qa[ks][1], b[0], b[1]);
      mma_bf16(sacc[1], qa[ks][0], qa[ks][1], b[2], b[3]);
    }
    const int col = warp * 16 + 2 * (lane & 3);   // slot of sacc[0][0]
    float sv[2][2], mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sv[nt][e] = col + 8 * nt + e < live ? sacc[nt][e] * qscale : kNegInf;
        mx = fmaxf(mx, sv[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx), corr = ex2(m - mn);
    m = mn;
    l *= corr;
    if (__any_sync(0xffffffffu, corr != 1.f))
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= corr;
        o[nt][1] *= corr;
      }
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = col + 8 * nt + e < live ? ex2(sv[nt][e] - mn) : 0.f;
        l += p[nt][e];
      }
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(p[0][0], p[0][1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(p[1][0], p[1][1]);
    const uint32_t hi0 = bits(h0), hi1 = bits(h1);
    const uint32_t lo0 = bits(__floats2bfloat162_rn(
        p[0][0] - __low2float(h0), p[0][1] - __high2float(h0)));
    const uint32_t lo1 = bits(__floats2bfloat162_rn(
        p[1][0] - __low2float(h1), p[1][1] - __high2float(h1)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t v[4];
      ldsm_x4_t(v, at(tv, vofs, vx, 2 * np + vsel));
      mma_bf16(o[2 * np], hi0, hi1, v[0], v[1]);
      mma_bf16(o[2 * np], lo0, lo1, v[0], v[1]);
      mma_bf16(o[2 * np + 1], hi0, hi1, v[2], v[3]);
      mma_bf16(o[2 * np + 1], lo0, lo1, v[2], v[3]);
    }
  }

  __device__ void store(float* scr) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int g = lane >> 2, c = lane & 3;
    if (g >= GC) return;
    float* st = scr + (warp * GC + g) * (HD + 2);
    if (c == 0) {
      st[0] = m;
      st[1] = l;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      st[2 + 8 * nt + 2 * c] = o[nt][0];
      st[3 + 8 * nt + 2 * c] = o[nt][1];
    }
  }
};

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, Geo<T, HD, GC>::MIN_BLOCKS)
decode_tma_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const DecodeArgs a) {
  using L = Geo<T, HD, GC>;
  using Warp = std::conditional_t<L::MMA, MmaWarp<HD, GC>, CoreWarp<HD, GC>>;
  constexpr int TS = L::TS, STAGES = L::STAGES, PART = L::PART;
  constexpr int TILE = L::TILE, BOXES = L::MMA ? L::NB : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const base =
      smem_raw + ((L::ALIGN - (smem_addr(smem_raw) & (L::ALIGN - 1))) &
                  (L::ALIGN - 1));
  const uint32_t sk = smem_addr(base), sv = sk + STAGES * TILE;
  float* const scr = reinterpret_cast<float*>(base + 2 * STAGES * TILE);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(scr + kConsumerWarps * PART);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = first_tile(a, blockIdx.x);
  const int x1 = first_tile(a, blockIdx.x + 1);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {            // the producer: one thread
    if (lane == 0) {
      for (int x = x0; x < x1; ++x) {
        const int it = x - x0, s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
        const int row = x / a.T, t = x - row * a.T, bk = row / a.NG;
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * TILE);
#pragma unroll
        for (int cb = 0; cb < BOXES; ++cb) {
          const uint32_t off = s * TILE + cb * TS * L::RP;
          tma_load_4d(sk + off, &tk, full, cb * L::BW, t * TS, bk % a.K,
                      bk / a.K);
          tma_load_4d(sv + off, &tv, full, cb * L::BW, t * TS, bk % a.K,
                      bk / a.K);
        }
      }
    }
    return;
  }

  Warp cw(warp, lane);
  int row = -1, bk = 0, g0 = 0, seg_t0 = 0;
  for (int x = x0; x < x1; ++x) {
    const int it = x - x0, s = it % STAGES;
    const int r = x / a.T, t = x - r * a.T;
    if (r != row) {                        // a new row segment: q and state
      row = r;
      seg_t0 = t;
      bk = r / a.NG;
      g0 = (r - bk * a.NG) * GC;
      const T* qp = static_cast<const T*>(a.q) + (bk / a.K) * a.q_sb +
                    (bk % a.K) * a.q_sk;
      if constexpr (L::MMA) cw.begin(qp, a.q_sg, g0, a.G);
      else cw.begin(qp, a.q_sg, g0, a.G, a.qscale);
    }
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const int live = a.valid - t * TS;     // live slots of this tile, >= 1
    if constexpr (L::MMA) {
      cw.tile(sk + s * TILE, sv + s * TILE, live, a.qscale);
    } else {
      cw.tile(reinterpret_cast<const float*>(base + s * TILE),
             reinterpret_cast<const float*>(base + (STAGES + s) * TILE),
             live);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);

    if (t != a.T - 1 && x != x1 - 1) continue;
    // the segment ends: the 4 warps' states merge through the scratch
    consumers_sync();                      // the last merge has read scr
    cw.store(scr);
    consumers_sync();
    const bool whole = seg_t0 == 0 && t == a.T - 1;
    const int slot = r == x0 / a.T ? 0 : 1;   // the block's first segment?
    float* const part = a.ws + (2ll * blockIdx.x + slot) * PART;
#pragma unroll 1
    for (int i = tid; i < GC * HD; i += kConsumers) {
      const int g = i / HD, d = i % HD;
      const float3 res = merge_warps(scr + g * (HD + 2), GC * (HD + 2), d);
      if (whole) {
        if (g0 + g < a.G) write_out<T>(a, bk, g0 + g, d, res);
      } else {
        float* st = part + g * (HD + 2);
        st[2 + d] = res.x;
        if (d == 0) {
          st[0] = res.z;
          st[1] = res.y;
        }
      }
    }
  }
}

// the rows whose tiles several blocks of decode_tma_kernel share: block b0
// + c's share of row r is its first segment's state, but block b0's when
// it starts before row r (its last segment's). One block of the consumer
// warps' size a (row, head group) merges them in one pass over the shares
// (a running max, the sum and each column rescaled as it moves: every load
// is issued at once, one round trip to L2) into o (and the lse). Launched
// with programmatic stream serialization, it is set up while that grid
// runs and waits for its end (griddepcontrol.wait)
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kConsumers)
decode_merge_kernel(const DecodeArgs a) {
  using L = Geo<T, HD, GC>;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int r = blockIdx.x;
  const int b0 = block_of(a, r * a.T);
  const int nc = block_of(a, r * a.T + a.T - 1) - b0 + 1;
  if (nc == 1) return;                     // written whole by its block
  const int bk = r / a.NG, g0 = (r - bk * a.NG) * GC;
  const int sl0 = first_tile(a, b0) == r * a.T ? 0 : 1;
  for (int i = threadIdx.x; i < GC * HD; i += kConsumers) {
    const int g = i / HD, d = i % HD;
    if (g0 + g >= a.G) continue;
    const float* st = a.ws + (2ll * b0 + sl0) * L::PART + g * (HD + 2);
    float mx = kNegInf, den = 0.f, num = 0.f;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const float mc = st[0], lc = st[1], ac = st[2 + d];
      const float mn = fmaxf(mx, mc), fo = ex2(mx - mn), fc = ex2(mc - mn);
      den = fmaf(den, fo, lc * fc);
      num = fmaf(num, fo, ac * fc);
      mx = mn;
      // block b0 + c + 1 starts in row r: its first segment's slot
      st = a.ws + 2ll * (b0 + c + 1) * L::PART + g * (HD + 2);
    }
    write_out<T>(a, bk, g0 + g, d, make_float3(num, den, mx));
  }
}

// query heads a block serves at once: 1, 2, 4 or 8 (more: groups of 8)
int group_size(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <typename T, int HD, int GC>
cudaError_t launch_gc(const DecodeArgs& a, const CUtensorMap& tk,
                      const CUtensorMap& tv, int grid, cudaStream_t st) {
  using L = Geo<T, HD, GC>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_tma_kernel<T, HD, GC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  decode_tma_kernel<T, HD, GC><<<grid, kThreads, L::SMEM, st>>>(tk, tv, a);
  err = cudaGetLastError();
  bool split = false;          // does a block boundary fall inside a row?
  for (int i = 1; i < grid && !split; ++i)
    split = (i * a.tq + i * a.tr / grid) % a.T != 0;
  if (err != cudaSuccess || !split) return err;
  // a merge unless every row lies in one block; launched while the first
  // grid runs (programmatic stream serialization), it waits for its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.K * a.NG);
  cfg.blockDim = dim3(kConsumers);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, HD, GC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// blocks of the (T, HD, GC) instance that fit one SM, or -error
template <typename T, int HD, int GC>
int occupancy_gc() {
  using L = Geo<T, HD, GC>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_tma_kernel<T, HD, GC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_tma_kernel<T, HD, GC>, kThreads, L::SMEM);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// the instances of (T, HD) by head group: their launch, occupancy, tiles
// and TMA box
template <typename T, int HD>
struct ByGroup {
  template <int GC>
  using G_ = Geo<T, HD, GC>;
  // the box of K or V a load brings (columns, slots) and its swizzle
  static void box(cuuint32_t* box, CUtensorMapSwizzle* sw) {
    using L = G_<1>;
    box[0] = L::MMA ? L::BW : HD;
    box[1] = L::TS;
    box[2] = box[3] = 1;
    *sw = !L::MMA || !L::SWZ ? CU_TENSOR_MAP_SWIZZLE_NONE
          : L::RP == 128        ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_32B;
  }
  static cudaError_t launch(const DecodeArgs& a, const CUtensorMap& tk,
                            const CUtensorMap& tv, int grid,
                            cudaStream_t st) {
    switch (group_size(a.G)) {
      case 1: return launch_gc<T, HD, 1>(a, tk, tv, grid, st);
      case 2: return launch_gc<T, HD, 2>(a, tk, tv, grid, st);
      case 4: return launch_gc<T, HD, 4>(a, tk, tv, grid, st);
      default: return launch_gc<T, HD, 8>(a, tk, tv, grid, st);
    }
  }
  static int occupancy(int G) {
    switch (group_size(G)) {
      case 1: return occupancy_gc<T, HD, 1>();
      case 2: return occupancy_gc<T, HD, 2>();
      case 4: return occupancy_gc<T, HD, 4>();
      default: return occupancy_gc<T, HD, 8>();
    }
  }
  static void geometry(int* out) {
    out[0] = G_<1>::TS;
    out[1] = G_<1>::SPW;
    out[2] = kConsumerWarps;
  }
};

// `fn` on ByGroup<T, hd> for a dtype code and head_dim; false if unknown
template <typename Fn>
bool dispatch(int dtype, int hd, Fn fn) {
  auto by_hd = [&](auto tag) {
    using T = decltype(tag);
    switch (hd) {
      case 16: fn(ByGroup<T, 16>()); return true;
      case 64: fn(ByGroup<T, 64>()); return true;
      case 112: fn(ByGroup<T, 112>()); return true;
      case 128: fn(ByGroup<T, 128>()); return true;
      case 256: fn(ByGroup<T, 256>()); return true;
      default: return false;
    }
  };
  if (dtype == 0) return by_hd(float());
  if (dtype == 1) return by_hd(__nv_bfloat16());
  return false;
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// the tiles of dtype code `dtype` at `hd` into `out`: slots a tile, slots a
// warp step, consumer warps (decode_attention.py::geometry must give the
// same); returns 0 for a dtype or head_dim the kernel is not built for
int decode_attention_geometry(int hd, int dtype, int* out) {
  return dispatch(dtype, hd, [&](auto by) { by.geometry(out); }) ? 1 : 0;
}

// blocks of the instance for (hd, dtype, G) that fit one SM (the default
// grid is the SMs times this); a negative cudaError_t on failure
int decode_attention_blocks_per_sm(int hd, int dtype, int G) {
  int n = -static_cast<int>(cudaErrorInvalidValue);
  dispatch(dtype, hd, [&](auto by) { n = by.occupancy(G); });
  return n;
}

// q, o: (B, K, G, hd) and k, v: (B, K, C, hd) addressed through the 12
// element strides in `st` (q b,k,g; k b,k,c; v b,k,c; o b,k,g); head_dim
// contiguous, every stride of an axis longer than 1 a multiple of 16 bytes
// (TMA's rule). Slots [0, valid) are live. `grid` blocks (at most the
// tiles) split the tiles evenly; `ws` holds 2 * grid partial states of
// group_size(G) * (hd + 2) floats: the shares of rows that several blocks
// hold, which a second launch (decode_merge_kernel) merges. `lse`, unless
// null, receives
// each head's log-sum-exp of its scaled scores over the live slots, (B, K,
// G) contiguous float32. dtype 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError().
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, float* lse, float* ws,
                            const long long* st, int B, int K, int G, int hd,
                            int valid, int grid, float scale, int dtype,
                            void* stream) {
  int geo[3];
  if (B < 1 || K < 1 || G < 1 || valid < 1 ||
      !decode_attention_geometry(hd, dtype, geo))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q; a.o = o; a.lse = lse; a.ws = ws;
  a.q_sb = st[0]; a.q_sk = st[1]; a.q_sg = st[2];
  a.o_sb = st[9]; a.o_sk = st[10]; a.o_sg = st[11];
  a.B = B; a.K = K; a.G = G; a.valid = valid;
  a.NG = (G + group_size(G) - 1) / group_size(G);
  a.T = (valid + geo[0] - 1) / geo[0];
  const long long n = static_cast<long long>(B) * K * a.NG * a.T;
  if (n >= (1ll << 31) || grid < 1 || grid > n || grid > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  a.N = static_cast<int>(n);
  a.nb = grid;
  a.tq = a.N / grid;
  a.tr = a.N % grid;
  a.qscale = scale * kLog2e;
  // (hd, slots, K, B) over the cache's strides, the slot extent `valid`:
  // TMA zero-fills a tile's rows past it
  CUtensorMap tk, tv;
  const long long dims[4] = {hd, valid, K, B};
  const long long ks[3] = {st[5], st[4], st[3]};
  const long long vs[3] = {st[8], st[7], st[6]};
  cuuint32_t box[4];
  CUtensorMapSwizzle sw;
  dispatch(dtype, hd, [&](auto by) { by.box(box, &sw); });
  const CUtensorMapDataType type = dtype == 0
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int es = dtype == 0 ? 4 : 2;
  // rows of whole 128-byte lines are fetched 256 bytes at a time; rows
  // that straddle lines (hd 112: 224 bytes) as they are
  const CUtensorMapL2promotion l2 = hd * es % 128 == 0
      ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_NONE;
  if (!tensor_map(&tk, type, es, k, 4, dims, ks, box, sw, l2) ||
      !tensor_map(&tv, type, es, v, 4, dims, vs, box, sw, l2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch(dtype, hd, [&](auto by) { err = by.launch(a, tk, tv, grid, s); });
  return static_cast<int>(err);
}

}  // extern "C"
