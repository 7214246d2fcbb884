// Intra-chunk SSD quadratic form of Mamba2 for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel repro/kernels/ssd_scan.py (_ssd_kernel,
// called through ssd_intra_folded). For every chunk bc, row i < Q and head h,
//
//     out[bc, i, h, :] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * x[bc, j, h, :]
//
// in float32. Entries with j > i are set to zero before any exp is taken:
// there cum_i - cum_j >= 0 can be large and exp of it is inf.
//
// What bounds it on the H100: at mamba2-2.7b's serving shape (BC = 64
// chunks of Q = 256, H = 80 heads of P = 64, state N = 128) the causal band
// is ~2.2e10 FLOPs against ~0.69 GB of x, out, cum, B and C. In float32 on
// the CUDA cores that is bound by operations (0.34 ms at 67 TFLOP/s); on
// the tensor cores the bytes bound it (0.21 ms), so both routes run both
// products there, in 3xTF32:
//
//   * TF32 keeps 10 mantissa bits, ~1e-3 relative, too coarse for the 1e-4
//     float32 tolerance. Each operand a is split as hi = rna_tf32(a),
//     lo = rna_tf32(a - hi), and each product is hi.hi + (lo.hi + hi.lo):
//     the large term and the two small ones go to separate fp32
//     accumulators, added at the end, so the small terms are not rounded
//     against the large running sum (with one accumulator for all three,
//     exploratory builds strayed further from a float64 reference). The
//     dropped lo.lo term is ~2^-22 relative. The scores C . B^T (over N)
//     and W . x (over j) both run this way. The decay weights
//     W = scores * 2^((cum_i - cum_j) log2 e) are made in fp32 registers,
//     with j > i (and i >= Q) set to 0 before the exp (ex2.approx, ~2^-22
//     relative) is taken, then split. Both routes round at these points
//     (but for the wgmma route's lo parts, below); tests/test_torch_ssd.py
//     emulates each on the CPU.
//
// Two routes behind one entry point, chosen on the host from the shape
// (ssd_scan.py::route; never as a fallback):
//
// wgmma (P = 64, N = 64 or 128: every served model), ssd_wgmma_kernel.
//   * A persistent grid, one block an SM (226 KB of shared memory), draws
//     work items (chunk, 64-row tile, group of <= 16 heads) from a counter
//     in device memory that the host zeroes for each launch, in the order
//     of ssd_scan.py::work_list: windows of chunks in turn, in each the
//     heaviest row tile first, so that a chunk's row tiles meet its x tiles
//     in the L2. (Without a counter, block b walks items b, b + grid, ..:
//     the static walk the drawn one is timed against.)
//   * 384 threads: a producer warpgroup and two consumer warpgroups, which
//     own the item's 64 rows and take alternate j tiles of its scores and
//     alternate heads of its group (equal work; the scores are shared).
//     setmaxnreg gives the consumers 224 registers, the producer 56.
//   * Loads: the producer's first thread keeps TMA loads in flight into a
//     ring of kRaw 8 KB stages, each completing on the mbarrier of the
//     consumer that owns it: B items (64 j x 32 state columns, a 3-D map
//     through B's strides, so a column slice of the fused xBC row is read
//     in place) and x items (32 j x 64 p, a 4-D map over (BC, Q, H, P)),
//     with the 128-byte swizzle; and the item's C rows (64 x N) once. Rows
//     past a ragged chunk's Q are zero-filled by the TMA unit. Warps 1-3
//     gather cum (BC, Q, H) with plain loads into a [head][row] table: its
//     row stride, H floats, need not be the multiple of 16 bytes TMA takes.
//   * x split once an item: wgmma takes TF32 operands from shared memory
//     K-major only, and x lies (j, p), MN-major. So each x item is split
//     into hi and lo parts written transposed (p rows of 32 j, swizzled as
//     the descriptor names), by the consumer that owns it, into the second
//     of its two split buffers while its products on the first run. Within
//     each 8 j the columns are stored as 0 2 4 6 1 3 5 7: wgmma's register
//     fragment of A holds k columns t and t + 4 of a thread, and in this
//     order they are the adjacent j = 2t, 2t + 1 that one 8-byte load of
//     the scores and of cum brings. A B item is split in place of its
//     layout.
//   * Scores: C . B^T for 64-column j tiles up to the diagonal, wgmma
//     m64n64k8 with C from registers (split as loaded) over the split B
//     items, three products a k8 step, into shared memory (64 x 260 fp32),
//     once for the head group.
//   * W . x: per head, each thread builds its fragments of W from the
//     scores and cum in registers and splits them; three wgmma m64n64k8 a
//     k8 step take W as the register A operand over the split x item.
//     Steps are built and issued in pairs with up to four in flight (the
//     wgmma latency is several times its issue time); fragments a pending
//     wgmma reads are never rewritten, and nothing but wgmma writes an
//     accumulator (a run's first product overwrites it), else ptxas
//     serializes the products. A head's 64 x 64 output goes through the
//     split buffer of its last item (128-byte swizzled) and a TMA store
//     into (BC, Q, H, P) in place; the unit clips rows past Q.
//   * The wgmma route's lo parts are a - hi as it is: the tensor core reads
//     a TF32 operand's top 19 bits, so lo is truncated where the mma route
//     rounds it, ~2^-22 relative to a either way (two instructions fewer a
//     split).
//   * What bounds it: not the tensor cores (about a third of their TF32
//     peak issued) nor the bytes. Each consumer warp spends ~75
//     instructions a k8 step building and splitting W and x around three
//     products, in dependent chains (shared-memory loads, ex2, the
//     splits) that two consumer warps a scheduler only half hide. PERF.md
//     has the measurements.
//
// mma (every other P and N: the reference sweep's widths), ssd_mma_kernel:
//   the earlier design. mma.sync m16n8k8 with fragments built in registers,
//   cp.async double buffers, one block of 4 warps per (32-row i tile,
//   group of <= 16 heads, chunk), three blocks an SM; the block computes
//   its rows' scores C_i . B_j once into shared memory and reuses them for
//   every head of its group; rows past Q and columns past N or P are
//   zero-filled by the copy (src-size 0). It takes P and N multiples of 4
//   up to 128. Its limit was the work around the products (one copy wait
//   and barrier per item, the weights and splits in the products' warps).
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma_common.cuh"    // tensor maps, mbarriers and TMA loads

namespace {

constexpr int kMaxQ = 256;
constexpr int kMaxPN = 128;     // largest head_dim P and state N
constexpr float kLog2e = 1.4426950408889634f;

struct SsdArgs {
  const float* x;
  const float* cum;
  const float* B;
  const float* C;
  float* o;  // contiguous (BC, Q, H, P)
  // element strides: x over (BC, Q, H) and cum over (BC, Q, H); B and C over
  // (BC, Q); the last axis of x, B and C is contiguous
  long long x_sb, x_sq, x_sh;
  long long l_sb, l_sq, l_sh;
  long long b_sb, b_sq;
  long long c_sb, c_sq;
  int Q, H, P, N, heads_per_block;
  // the wgmma route: chunks, chunks per window of the work list, work
  // items, and the counter they are drawn from (null: a static walk)
  int BC, window, total;
  int* counter;
};

// 2^x, the MUFU approximation (relative error ~2^-22); subnormal results
// flush to 0, where a weight is negligible beside the scores
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// mma route: mma.sync, cp.async
// ---------------------------------------------------------------------------

namespace mma {


constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBI = 32;         // rows i per block
constexpr int kBJ = 64;         // columns j per tile
constexpr int kBN = 32;         // state columns per step of the score pass
constexpr int kHeadGroup = 16;  // most heads per block
constexpr int kCS = kBN + 4;    // row stride of the C and B tiles
constexpr int kStages = 2;      // tiles in flight: copies run a tile ahead


__host__ __device__ constexpr int score_stride(int q) {
  return (q + kBJ - 1) / kBJ * kBJ + 4;
}

// x tiles are PT columns wide (P is walked in PT-wide column tiles)
__host__ __device__ constexpr int x_stride(int pt) { return pt + 8; }

// one pipeline stage of the region the two passes share: a C tile (kBI
// rows) and a B tile (kBJ rows) of kCS, or an x tile of kBJ x XS
__host__ __device__ constexpr int stage_floats(int pt) {
  return (kBI + kBJ) * kCS > kBJ * x_stride(pt) ? (kBI + kBJ) * kCS
                                                 : kBJ * x_stride(pt);
}

// shared floats: scores; the stages; a buffer of one head's cum rows (kBI
// i, then up to kMaxQ j) per stage
__host__ __device__ constexpr int smem_floats(int q, int pt) {
  return kBI * score_stride(q) + kStages * stage_floats(pt) +
         kStages * (kBI + kMaxQ);
}

__device__ __forceinline__ float to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// a = hi + lo, both TF32
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const float h = to_tf32(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(to_tf32(a - h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 of the float32 fragments a (A operand) and b0, b1 (B operand):
// big += hi.hi; small += lo.hi + hi.lo, in its own accumulator so the small
// terms are not rounded against the large running sum
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// 16 bytes, or 16 zero bytes when !ok (src must still be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}


// PT: the width of a column tile of x and out (16, 32 or 64); P is walked
// in ceil(P / PT) of them. Warp w owns rows 16 (w % 2) .. + 16 of the block
// and the column half w / 2 (of j in the score pass, of a P tile after).
template <int PT>
__global__ void __launch_bounds__(kThreads, 3) ssd_mma_kernel(const SsdArgs a) {
  constexpr int NT = PT / 16;              // n8 tiles per warp, head pass
  constexpr int XS = x_stride(PT);
  constexpr int kStage = stage_floats(PT);
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int SS = score_stride(Q);
  float* sS = smem;                        // [kBI][SS] scores C_i . B_j
  float* sU = sS + kBI * SS;               // [kStages][kStage]
  float* sL = sU + kStages * kStage;       // [kStages][kBI + kMaxQ] cum

  const int t = gridDim.x - 1 - blockIdx.x;  // heaviest i tile first
  const int h0 = blockIdx.y * a.heads_per_block;
  const int bc = blockIdx.z;
  const int i0 = t * kBI;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;    // mma groupID, thread in group
  const int wr = (warp & 1) * 16;            // this warp's first row
  const int wc = warp >> 1;                  // this warp's column half
  const int jtiles = (i0 + kBI - 1) / kBJ + 1;  // j tiles up to the diagonal

  const float* Bp = a.B + bc * a.b_sb;
  const float* Cp = a.C + bc * a.c_sb;

  // ---- 1. scores of rows i0 .. i0+31 against every j tile up to them -------
  const int n_steps = (N + kBN - 1) / kBN;
  const int n_score = jtiles * n_steps;      // items (j tile, state chunk)
  auto load_score = [&](int item) {
    const int jt = item / n_steps, n0 = (item % n_steps) * kBN;
    float* c = sU + (item % kStages) * kStage;
    for (int e = tid; e < (kBI + kBJ) * (kBN / 4); e += kThreads) {
      const int r = e / (kBN / 4), q = e % (kBN / 4);
      const int n = n0 + 4 * q;
      const int row = r < kBI ? i0 + r : jt * kBJ + r - kBI;
      const float* src = r < kBI ? Cp + (long long)row * a.c_sq
                                 : Bp + (long long)row * a.b_sq;
      const bool ok = row < Q && n < N;
      cp_async16(c + r * kCS + 4 * q, ok ? src + n : Bp, ok);
    }
  };

  float acc[4][4], accs[4][4];               // 16 rows x 32 columns a warp
  load_score(0);
  cp_async_commit();
  for (int item = 0; item < n_score; ++item) {
    cp_async_wait_all();
    __syncthreads();                         // item in; item - 1 consumed
    if (item + 1 < n_score) load_score(item + 1);
    cp_async_commit();
    const int jt = item / n_steps, step = item % n_steps;
    if (step == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = accs[nt][e] = 0.f;
    }
    const float* c = sU + (item % kStages) * kStage;
    const float* b = c + kBI * kCS;
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 8) {
      uint32_t ah[4], al[4];
      split(c[(wr + g) * kCS + kk + tg], ah[0], al[0]);
      split(c[(wr + g + 8) * kCS + kk + tg], ah[1], al[1]);
      split(c[(wr + g) * kCS + kk + tg + 4], ah[2], al[2]);
      split(c[(wr + g + 8) * kCS + kk + tg + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* br = b + (wc * 32 + nt * 8 + g) * kCS + kk;
        mma3(acc[nt], accs[nt], ah, al, br[tg], br[tg + 4]);
      }
    }
    if (step == n_steps - 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = jt * kBJ + wc * 32 + nt * 8 + 2 * tg;
        *reinterpret_cast<float2*>(sS + (wr + g) * SS + col) = make_float2(
            acc[nt][0] + accs[nt][0], acc[nt][1] + accs[nt][1]);
        *reinterpret_cast<float2*>(sS + (wr + g + 8) * SS + col) = make_float2(
            acc[nt][2] + accs[nt][2], acc[nt][3] + accs[nt][3]);
      }
    }
  }

  // ---- 2. every head of the group reuses the scores -------------------------
  // items (head, column tile of P, j tile)
  const int h1 = min(h0 + a.heads_per_block, a.H);
  const int n_ptiles = (P + PT - 1) / PT;
  const int per_head = n_ptiles * jtiles;
  const int n_items = (h1 - h0) * per_head;
  const int jlim = jtiles * kBJ;
  auto load_head = [&](int item) {
    const int hr = item / per_head, rem = item % per_head;
    const int p0 = rem / jtiles * PT, jt = rem % jtiles;
    const float* xp = a.x + bc * a.x_sb + (h0 + hr) * a.x_sh + p0;
    float* xs = sU + (item % kStages) * kStage;
    for (int e = tid; e < kBJ * (PT / 4); e += kThreads) {
      const int r = e / (PT / 4), q = e % (PT / 4);
      const int j = jt * kBJ + r;
      const bool ok = j < Q && p0 + 4 * q < P;
      cp_async16(xs + r * XS + 4 * q,
                 ok ? xp + (long long)j * a.x_sq + 4 * q : a.x, ok);
    }
    if (rem == 0) {                          // this head's cum rows
      const float* lp = a.cum + bc * a.l_sb + (h0 + hr) * a.l_sh;
      float* ls = sL + (hr % kStages) * (kBI + kMaxQ);
      for (int e = tid; e < kBI + jlim; e += kThreads) {
        const int q = e < kBI ? i0 + e : e - kBI;
        const bool ok = q < Q;
        cp_async4(ls + e, ok ? lp + (long long)q * a.l_sq : lp, ok);
      }
    }
  };

  float o[NT][4], os[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = os[nt][e] = 0.f;
  const int r0 = wr + g, r1 = r0 + 8;        // this thread's rows in the tile
  const bool live0 = i0 + r0 < Q, live1 = i0 + r1 < Q;
  const int c0 = wc * 8 * NT;                // this warp's first column
  __syncthreads();                           // scores written; sU consumed
  load_head(0);
  cp_async_commit();
  for (int item = 0; item < n_items; ++item) {
    cp_async_wait_all();
    __syncthreads();                         // item in; item - 1 consumed
    if (item + 1 < n_items) load_head(item + 1);
    cp_async_commit();
    const int hr = item / per_head, rem = item % per_head;
    const int p0 = rem / jtiles * PT, jt = rem % jtiles;
    const float* ls = sL + (hr % kStages) * (kBI + kMaxQ);
    const float* lj = ls + kBI;
    const float li0 = ls[r0], li1 = ls[r1];
    const float* xs = sU + (item % kStages) * kStage;
    // A j tile wholly at or below the block's rows needs no mask (rows past
    // Q read zero-filled cum and scores, and are never stored).
    auto products = [&](auto below) {
      constexpr bool kBelow = decltype(below)::value;
#pragma unroll 2
      for (int kk = 0; kk < kBJ; kk += 8) {
        const int j0 = jt * kBJ + kk;
        if (!kBelow && j0 > i0 + wr + 15) break;  // this warp's rows end
        uint32_t ah[4], al[4];
        const int ja = j0 + tg, jb = ja + 4;
        const float la = lj[ja], lb = lj[jb];
        const float s0a = sS[r0 * SS + ja], s1a = sS[r1 * SS + ja];
        const float s0b = sS[r0 * SS + jb], s1b = sS[r1 * SS + jb];
        // weights, 0 where j > i (or i >= Q) before any exp is taken
        split(kBelow || (live0 && ja <= i0 + r0)
                  ? s0a * ex2((li0 - la) * kLog2e) : 0.f, ah[0], al[0]);
        split(kBelow || (live1 && ja <= i0 + r1)
                  ? s1a * ex2((li1 - la) * kLog2e) : 0.f, ah[1], al[1]);
        split(kBelow || (live0 && jb <= i0 + r0)
                  ? s0b * ex2((li0 - lb) * kLog2e) : 0.f, ah[2], al[2]);
        split(kBelow || (live1 && jb <= i0 + r1)
                  ? s1b * ex2((li1 - lb) * kLog2e) : 0.f, ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* xc = xs + (kk + tg) * XS + c0 + nt * 8 + g;
          mma3(o[nt], os[nt], ah, al, xc[0], xc[4 * XS]);
        }
      }
    };
    if (jt * kBJ + kBJ - 1 <= i0)
      products(std::true_type{});
    else
      products(std::false_type{});
    if (jt == jtiles - 1) {                  // these rows and columns are done
      const int h = h0 + hr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = p0 + c0 + nt * 8 + 2 * tg;
        if (col < P) {
          if (live0)
            *reinterpret_cast<float2*>(
                a.o + (((long long)bc * Q + i0 + r0) * a.H + h) * P + col) =
                make_float2(o[nt][0] + os[nt][0], o[nt][1] + os[nt][1]);
          if (live1)
            *reinterpret_cast<float2*>(
                a.o + (((long long)bc * Q + i0 + r1) * a.H + h) * P + col) =
                make_float2(o[nt][2] + os[nt][2], o[nt][3] + os[nt][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = os[nt][e] = 0.f;
      }
    }
  }
}

template <int PT>
cudaError_t launch_pt(const SsdArgs& a, int BC, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(a.Q, PT);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_i = (a.Q + kBI - 1) / kBI;
  const int n_g = (a.H + a.heads_per_block - 1) / a.heads_per_block;
  ssd_mma_kernel<PT><<<dim3(n_i, n_g, BC), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}


}  // namespace mma

// ---------------------------------------------------------------------------
// wgmma route: TMA, split stages, wgmma with W from registers
// ---------------------------------------------------------------------------

namespace wg {

using namespace tma;

constexpr int kRows = 64;         // rows i of a work item: one wgmma m64
constexpr int kThreads = 384;     // a producer warpgroup and two consumers
constexpr int kMaxHeads = 16;     // heads of a group (rows of the cum table)
constexpr int kRaw = 6;           // raw TMA stages
constexpr int kSplit = 2;         // split (hi, lo) buffers of a consumer
constexpr int kSS = 260;          // row stride of the scores, floats
constexpr int kCS = 258;          // row stride of the cum table, floats
// an item is one 64 x 32 fp32 block: 64 rows (j of B, p of x) by 32 k
// columns, four k8 steps; raw and split as 128-byte-swizzled blocks
constexpr int kBlock = 64 * 128;
constexpr int kOffSplit = kRaw * kBlock;      // raw stages first
constexpr int kOffC = kOffSplit + 2 * kSplit * 2 * kBlock;
constexpr int kOffS = kOffC + 4 * kBlock;     // C: 64 rows x N <= 128
constexpr int kOffCum = kOffS + kRows * kSS * 4;
constexpr int kOffBar = kOffCum + kMaxHeads * kCS * 4;
// mbarriers: raw stages' full (one per stage and consumer: the producer's
// expect-tx, then the TMA bytes) and empty (each warp of the consumer that
// split it); the item's C rows (and its index), its cum table (one
// arrival each), scores done, heads done (each consumer warp)
constexpr int kFull = 0, kEmpty = 2 * kRaw, kCFull = kEmpty + kRaw;
constexpr int kCumFull = kCFull + 1, kScoresDone = kCumFull + 1;
constexpr int kHeadsDone = kScoresDone + 1, kBars = kHeadsDone + 1;
// the 1024-byte alignment the swizzle needs, the regions, the barriers and
// three ints (the item the consumers take, the producer's two copies)
constexpr int kSmem = 1024 + kOffBar + 8 * kBars + 16;
static_assert(kSmem <= 232448, "more shared memory than a block can have");
// named barriers: 1, 2 both consumers, 3 + c consumer c, 5 the producer
// warpgroup, 6 its cum warps
constexpr int kCumBar = 5;

// integer form of cvt.rna.tf32.f32 on finite values: to nearest, ties away
// from zero, the 13 low bits cleared
__device__ __forceinline__ uint32_t round_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo: hi TF32, lo = a - hi as it is (exact in float32). The tensor
// core reads a TF32 operand's top 19 bits, so it reads lo truncated: ~2^-22
// relative to a, as a rounded lo would be (tests/test_torch_ssd.py
// emulates it), for two instructions fewer
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

struct Smem {
  unsigned char* p;  // the aligned base, generic
  uint32_t a;        // and shared
  __device__ uint32_t raw(int r) const { return a + r * kBlock; }
  // consumer c's split buffer b: hi, then lo
  __device__ uint32_t hi(int c, int b) const {
    return a + kOffSplit + (c * kSplit + b) * 2 * kBlock;
  }
  __device__ uint32_t lo(int c, int b) const { return hi(c, b) + kBlock; }
  __device__ uint32_t ctile() const { return a + kOffC; }
  __device__ uint32_t bar(int i) const { return a + kOffBar + 8 * i; }
  template <class T>
  __device__ T* at(uint32_t addr) const {
    return reinterpret_cast<T*>(p + (addr - a));
  }
  __device__ float* scores() const { return at<float>(a + kOffS); }
  __device__ float* cum() const { return at<float>(a + kOffCum); }
  __device__ int* cw() const { return at<int>(bar(kBars)); }
  __device__ int* pw(int wl) const { return cw() + 1 + (wl & 1); }
};

// a work item: chunk bc, row tile t, head group g (ssd_scan.py::work_list:
// windows of `window` chunks in order; in each, row tiles from the last,
// then chunks, then groups)
struct Item {
  int bc, t, g;
};

__device__ __forceinline__ Item decode(const SsdArgs& a, int w, int nT,
                                       int G) {
  const int win_items = a.window * nT * G;
  const int win = w / win_items;
  const int c0 = win * a.window;
  const int wc = min(a.window, a.BC - c0);
  const int r = w - win * win_items;
  Item it;
  it.t = nT - 1 - r / (wc * G);
  const int r2 = r % (wc * G);
  it.bc = c0 + r2 / G;
  it.g = r2 % G;
  return it;
}

// the ring order of a phase's items: units u (j tiles of the scores, heads
// of W.x) in pairs, each pair's items v (32 state columns, 32 j) with the
// pair's two units alternating; an odd last unit's items follow in turn.
// Unit u is consumer u % 2's.
// (No division: the consumers call it while their products run, and ptxas
// makes a division by a run-time value a subroutine call, across which it
// serializes wgmma.)
__device__ __forceinline__ int pidx(int u, int v, int U, int V) {
  const int pairs = U >> 1;
  return u < 2 * pairs ? (u >> 1) * 2 * V + 2 * v + (u & 1)
                       : pairs * 2 * V + v;
}

__device__ __forceinline__ void pinv(int idx, int U, int V, int& u, int& v) {
  const int full = (U / 2) * 2 * V;
  if (idx < full) {
    const int rem = idx % (2 * V);
    u = 2 * (idx / (2 * V)) + (rem & 1);
    v = rem >> 1;
  } else {
    u = U - 1;
    v = idx - full;
  }
}

// d (m64 x n64, fp32) = [d +] A . B over k8 (`accumulate` 0 overwrites d),
// A TF32 from registers (a thread's rows r, r + 8 at columns t, t + 4: a[0]
// (r, t), a[1] (r + 8, t), a[2] (r, t + 4), a[3] (r + 8, t + 4)), B TF32
// K-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// one k8 step of 3xTF32: big += hi.Bhi, small += lo.Bhi + hi.Blo (the
// first step of a run overwrites both: no other instruction ever writes an
// accumulator, else ptxas serializes the products); f holds the hi
// fragments (0..3) and the lo ones (4..7); step kk's k columns lie 32 kk
// bytes into each row of the swizzled hi and lo blocks
__device__ __forceinline__ void step3(float (&big)[32], float (&sml)[32],
                                      uint32_t (&f)[8], uint32_t hi,
                                      uint32_t lo, int kk, bool first) {
  const uint32_t off = kk * 32;       // K-major: 8-row groups 1024 apart
  uint64_t dh = desc(hi + off, 16, 1024), dl = desc(lo + off, 16, 1024);
  // every operand made before the fence: the compiler would otherwise sink
  // the lo parts between the products, and ptxas then serializes them
  hold(f);
  asm volatile("" : "+l"(dh), "+l"(dl));
  wgmma_fence();
  mma_rs(big, f, dh, !first);
  mma_rs(sml, f + 4, dh, !first);
  mma_rs(sml, f, dl, 1);
  wgmma_commit();
}

// ---- splitting a raw item into TF32 parts (its consumer's 128 threads) --
// All loads come before the first store: the compiler cannot tell the raw
// and split blocks apart, and would hold each load behind the stores before

// a raw B item (64 j x 32 state columns) into its hi and lo parts, in place
// of its layout (K-major already): four 16-byte chunks a thread
__device__ __forceinline__ void split_flat(const float* raw, float* hi,
                                           float* lo, int t) {
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = *reinterpret_cast<const float4*>(raw + 4 * (t + 128 * i));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = 4 * (t + 128 * i);
    uint32_t h[4], l[4];
    split(v[i].x, h[0], l[0]);
    split(v[i].y, h[1], l[1]);
    split(v[i].z, h[2], l[2]);
    split(v[i].w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// a raw x item (32 j x 64 p: two swizzled 32 x 32 blocks, p halves) into hi
// and lo parts transposed: 64 p rows of 32 k, where k runs over each 8 j as
// 0 2 4 6 1 3 5 7. Thread t takes column t % 64 of half e = t / 64 of each
// 8 j: four loads of one column, one 16-byte store per part (a warp's loads
// cover one row's 32 columns, its stores 8 rows' chunks: both free of bank
// conflicts)
__device__ __forceinline__ void split_x(const float* raw, float* hi,
                                        float* lo, int t) {
  const int pc = t & 63, col = pc & 31, e = t >> 6;
  const float* src = raw + (pc >> 5) * 1024;
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 8 * i + 2 * u + e;
      v[i][u] = src[j * 32 + ((((col >> 2) ^ (j & 7)) << 2) | (col & 3))];
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split(v[i][u], h[u], l[u]);
    const int o = pc * 32 + (((2 * i + e) ^ (pc & 7)) << 2);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The ring of a work item's items, in order: its scores' (j tile, 32 state
// columns) B items, then its heads' (head, 32 j) x items. Unit u of either
// (j tile, head) is consumer u % 2's (pidx).
struct Items {
  int nj, i0, h0, hn, n_score, n_items;
  __device__ __forceinline__ Items(const SsdArgs& a, const Item& it) {
    nj = it.t + 1;
    i0 = it.t * kRows;
    h0 = it.g * a.heads_per_block;
    hn = min(a.heads_per_block, a.H - h0);
    n_score = nj * (a.N / 32);
    n_items = n_score + hn * 2 * nj;
  }
};

// ---- the producer warpgroup ----------------------------------------------

// Warp 0's first thread draws work items and keeps kRaw raw items in
// flight by TMA, each completing on its consumer's full barrier; warps 1-3
// gather each item's cum rows into the [head][row] table.
__device__ __forceinline__ void produce(const CUtensorMap* tx,
                                        const CUtensorMap* tb,
                                        const CUtensorMap* tc,
                                        const SsdArgs& a, const Smem& sm,
                                        int p) {
  const int nT = (a.Q + kRows - 1) / kRows;
  const int G = (a.H + a.heads_per_block - 1) / a.heads_per_block;
  const int NQ = a.N / 32;
  uint32_t k = 0;                      // ring items so far
  for (int wl = 0;; ++wl) {
    if (p == 0)                        // without a counter: items b,
      *sm.pw(wl) = a.counter ? atomicAdd(a.counter, 1)   // b + grid, ..
                             : static_cast<int>(blockIdx.x + wl * gridDim.x);
    bar_sync(kCumBar, 128);
    const int w = *sm.pw(wl);
    if (w >= a.total) {
      if (p == 0) {
        if (wl > 0) mbar_wait(sm.bar(kScoresDone), (wl - 1) & 1);
        *sm.cw() = -1;
        mbar_arrive(sm.bar(kCFull));
      }
      return;
    }
    const Item it = decode(a, w, nT, G);
    const Items in(a, it);
    if (p == 0) {
      if (wl > 0) mbar_wait(sm.bar(kScoresDone), (wl - 1) & 1);
      *sm.cw() = w;                    // C's last reader is done: reload
      mbar_expect_tx(sm.bar(kCFull), a.N * kRows * 4);
      for (int c = 0; c < NQ; ++c)
        tma_load_3d(sm.ctile() + c * kBlock, tc, sm.bar(kCFull), 32 * c,
                    in.i0, it.bc);
      for (int l = 0; l < in.n_items; ++l, ++k) {
        const int r = k % kRaw;
        if (k >= kRaw) mbar_wait(sm.bar(kEmpty + r), (k / kRaw - 1) & 1);
        const uint32_t dst = sm.raw(r);
        int u, v;
        if (l < in.n_score) {
          pinv(l, in.nj, NQ, u, v);    // j tile u, state columns 32 v
          const uint32_t bar = sm.bar(kFull + 2 * r + (u & 1));
          mbar_expect_tx(bar, kBlock);
          tma_load_3d(dst, tb, bar, 32 * v, 64 * u, it.bc);
        } else {
          pinv(l - in.n_score, in.hn, 2 * in.nj, u, v);   // head u, j 32 v
          const uint32_t bar = sm.bar(kFull + 2 * r + (u & 1));
          mbar_expect_tx(bar, kBlock);
          for (int c = 0; c < 2; ++c)
            tma_load_4d(dst + c * kBlock / 2, tx, bar, 32 * c, 32 * v,
                        in.h0 + u, it.bc);
        }
      }
    } else if (p >= 32) {
      // head p % 16 of rows (p - 32) / 16 + 6 i (0 past Q and the group),
      // once the last item's heads are done; loads ahead of stores (the
      // compiler cannot tell the cum table from the tensor)
      const int hl = p & 15, q0 = (p - 32) >> 4;
      const int qn = min(a.Q, in.nj * kRows);
      const float* lp = a.cum + it.bc * a.l_sb + (in.h0 + hl) * a.l_sh;
      float* tab = sm.cum() + hl * kCS;
      if (wl > 0) mbar_wait(sm.bar(kHeadsDone), (wl - 1) & 1);
      for (int q = q0; q < kMaxQ; q += 6 * 8) {
        float cv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int qi = q + 6 * i;
          cv[i] = hl < in.hn && qi < qn ? lp[qi * a.l_sq] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (q + 6 * i < kMaxQ) tab[q + 6 * i] = cv[i];
      }
      bar_sync(kCumBar + 1, 96);
      if (p == 32) mbar_arrive(sm.bar(kCumFull));
    }
  }
}

// ---- a consumer warpgroup ------------------------------------------------

// Consumer c's items of a work item, in ring order: the score items of j
// tiles c, c + 2, .. (NQ each), then the x items of heads c, c + 2, ..
// (2 nj each); an item is (u, v), its unit u (j tile, head) and v (32
// state columns, 32 j). Its ring index, with no division (see pidx)
__device__ __forceinline__ uint32_t ring(const Items& in, uint32_t k, int NQ,
                                         bool score, int u, int v) {
  return score ? k + pidx(u, v, in.nj, NQ)
               : k + in.n_score + pidx(u, v, in.hn, 2 * in.nj);
}

// consumer c's item after (u, v) (a score item if `score`): its ring index
// and kind; false after the last
__device__ __forceinline__ bool after(const Items& in, uint32_t k, int NQ,
                                      int c, bool score, int u, int v,
                                      uint32_t& kr, bool& flat) {
  if (score && v + 1 < NQ) {
    kr = ring(in, k, NQ, true, u, v + 1);
  } else if (score && u + 2 < in.nj) {
    kr = ring(in, k, NQ, true, u + 2, 0);
  } else if (score && c < in.hn) {
    kr = ring(in, k, NQ, false, c, 0);
    score = false;
  } else if (!score && v + 1 < 2 * in.nj) {
    kr = ring(in, k, NQ, false, u, v + 1);
  } else if (!score && u + 2 < in.hn) {
    kr = ring(in, k, NQ, false, u + 2, 0);
  } else {
    return false;
  }
  flat = score;
  return true;
}

// ring item kr (a score item if `flat`, else an x item) split into
// consumer c's buffer `b`, thread t: once its raw stage is in (`phase` bit
// r: the parity of full[r][c]'s next phase), which is handed back after
__device__ __forceinline__ void split_item(const Smem& sm, uint32_t kr,
                                           bool flat, int c, int b, int t,
                                           uint32_t& phase) {
  const int r = kr % kRaw;
  mbar_wait(sm.bar(kFull + 2 * r + c), (phase >> r) & 1);
  phase ^= 1u << r;
  const float* raw = sm.at<float>(sm.raw(r));
  float* hi = sm.at<float>(sm.hi(c, b));
  float* lo = sm.at<float>(sm.lo(c, b));
  if (flat)
    split_flat(raw, hi, lo, t);
  else
    split_x(raw, hi, lo, t);
  __syncwarp();
  if ((t & 31) == 0) mbar_arrive(sm.bar(kEmpty + r));
}

// C's element (r, n) in its swizzled raw tile
__device__ __forceinline__ float cval(const float* ct, int r, int n) {
  const int col = n & 31;
  return ct[(n >> 5) * (kBlock / 4) + r * 32 +
            ((((col >> 2) ^ (r & 7)) << 2) | (col & 3))];
}

// the fragments of a score step: C rows r0, r0 + 8 at state columns n and
// n + 4, split
__device__ __forceinline__ void build_c(uint32_t (&fr)[8], const float* ct,
                                        int r0, int n) {
  split(cval(ct, r0, n), fr[0], fr[4]);
  split(cval(ct, r0 + 8, n), fr[1], fr[5]);
  split(cval(ct, r0, n + 4), fr[2], fr[6]);
  split(cval(ct, r0 + 8, n + 4), fr[3], fr[7]);
}

// the fragments of W for rows r0, r0 + 8 at j = ja, ja + 1 (k columns t4
// and t4 + 4: the split x item's column order), split: the scores times
// 2^((cum_i - cum_j) log2 e), 0 where j > i when `diag` (jl: j within the
// diagonal tile, whose rows are r0's)
__device__ __forceinline__ void build_w(uint32_t (&fr)[8], const float* S,
                                        const float* cj, float ci0,
                                        float ci1, int r0, int ja, int jl,
                                        bool diag) {
  const float2 s0 = *reinterpret_cast<const float2*>(S + r0 * kSS + ja);
  const float2 s1 = *reinterpret_cast<const float2*>(S + (r0 + 8) * kSS + ja);
  const float2 cv = *reinterpret_cast<const float2*>(cj + ja);
  const int r1 = r0 + 8;
  split(!diag || jl <= r0 ? s0.x * ex2((ci0 - cv.x) * kLog2e) : 0.f, fr[0],
        fr[4]);
  split(!diag || jl <= r1 ? s1.x * ex2((ci1 - cv.x) * kLog2e) : 0.f, fr[1],
        fr[5]);
  split(!diag || jl + 1 <= r0 ? s0.y * ex2((ci0 - cv.y) * kLog2e) : 0.f,
        fr[2], fr[6]);
  split(!diag || jl + 1 <= r1 ? s1.y * ex2((ci1 - cv.y) * kLog2e) : 0.f,
        fr[3], fr[7]);
}

// Consumer c (0, 1), thread t: the item's 64 rows; warp w holds rows
// 16 w + g and + 8 (g = lane / 4), fragment column t4 = lane % 4. Its items
// come in runs (a j tile's scores, a head's W . x), each accumulating into
// big / sml and ending with its products drained and written (outside any
// branch: ptxas serializes wgmma around a wait in a divergent path). An
// item's four k8 steps each have their own fragments, built and issued in
// pairs, so that up to four steps' products are in flight (a wgmma's
// latency is several times its issue time: waiting for the last step at
// every step left the tensor cores idle most of the time) and each build
// has two independent chains: steps 0, 1 once the last item's steps 0, 1
// are done, steps 2, 3 once it is done. Then, with this item's four steps
// in flight, the next item is split into buffer m % 2 by the consumer's
// own threads (the last item, which read that buffer, is done).
__device__ __forceinline__ void consume(const CUtensorMap* to,
                                        const SsdArgs& a, const Smem& sm,
                                        int c, int t) {
  const int nT = (a.Q + kRows - 1) / kRows;
  const int G = (a.H + a.heads_per_block - 1) / a.heads_per_block;
  const int NQ = a.N / 32;
  const int lane = t & 31, t4 = lane & 3;
  const int r0 = 16 * (t >> 5) + (lane >> 2), r1 = r0 + 8;
  float* S = sm.scores();
  const float* ct = sm.at<float>(sm.ctile());
  uint32_t phase = 0;                  // bit r: parity of full[r][c]'s next
  uint32_t k = 0;                      // ring items so far
  uint32_t mine = 0;                   // items this consumer has taken
  float big[32], sml[32];
  uint32_t f[4][8];                    // step kk's fragments in f[kk]
  for (int wl = 0;; ++wl) {
    mbar_wait(sm.bar(kCFull), wl & 1);
    const int w = *sm.cw();
    if (w < 0) {
      if (t == 0) bulk_wait();         // the last output is written
      return;
    }
    const Item it = decode(a, w, nT, G);
    const Items in(a, it);
    const int nj = in.nj, i0 = in.i0, hn = in.hn;
    bar_sync(1, 256);                  // both are done with the last scores
    // the first item, split now; each later one during the one before
    if (c < nj || c < hn)
      split_item(sm, ring(in, k, NQ, c < nj, c, 0), c < nj, c, mine % kSplit,
                 t, phase);
    // scores S[r][j] = C_r . B_j of j tiles c, c + 2, ..
    for (int u = c; u < nj; u += 2) {
      for (int v = 0; v < NQ; ++v) {   // state columns 32 v ..
        uint32_t nkr = 0;
        bool nflat = true;
        const bool next = after(in, k, NQ, c, true, u, v, nkr, nflat);
        const int b = mine++ % kSplit, nb = mine % kSplit;
        const uint32_t hi = sm.hi(c, b), lo = sm.lo(c, b);
        fence_proxy_async();           // this item's parts, visible to wgmma
        if (t == 0) bulk_wait_read();  // the last output read from its buffer
        bar_sync(3 + c, 128);          // and written by every thread
        wgmma_wait<2>();               // the last item's steps 0, 1 done
        build_c(f[0], ct, r0, 32 * v + t4);
        build_c(f[1], ct, r0, 32 * v + 8 + t4);
        step3(big, sml, f[0], hi, lo, 0, v == 0);
        step3(big, sml, f[1], hi, lo, 1, false);
        wgmma_wait<2>();               // the last item done: f[2], f[3] and
        build_c(f[2], ct, r0, 32 * v + 16 + t4);   // its buffer free
        build_c(f[3], ct, r0, 32 * v + 24 + t4);
        step3(big, sml, f[2], hi, lo, 2, false);
        step3(big, sml, f[3], hi, lo, 3, false);
        if (next) split_item(sm, nkr, nflat, c, nb, t, phase);
      }
      wgmma_wait<0>();
      hold(big);
      hold(sml);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 64 * u + 8 * q + 2 * t4;
        *reinterpret_cast<float2*>(S + r0 * kSS + col) = make_float2(
            big[4 * q] + sml[4 * q], big[4 * q + 1] + sml[4 * q + 1]);
        *reinterpret_cast<float2*>(S + r1 * kSS + col) = make_float2(
            big[4 * q + 2] + sml[4 * q + 2], big[4 * q + 3] + sml[4 * q + 3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.bar(kScoresDone));
    bar_sync(2, 256);                  // every column of the scores written
    mbar_wait(sm.bar(kCumFull), wl & 1);

    // W . x of heads c, c + 2, ..: W in registers, k column t4 is j = 2 t4
    // and t4 + 4 is j = 2 t4 + 1 (the split x item's column order); 0 where
    // j > i on the diagonal j tile
    for (int u = c; u < hn; u += 2) {
      const float* cj = sm.cum() + u * kCS;
      const float ci0 = cj[i0 + r0], ci1 = cj[i0 + r1];
      for (int v = 0; v < 2 * nj; ++v) {   // j 32 v .. (jl: within its tile)
        uint32_t nkr = 0;
        bool nflat = false;
        const bool next = after(in, k, NQ, c, false, u, v, nkr, nflat);
        const int b = mine++ % kSplit, nb = mine % kSplit;
        const uint32_t hi = sm.hi(c, b), lo = sm.lo(c, b);
        const bool diag = (v >> 1) == nj - 1;
        const int j0 = 32 * v + 2 * t4, l0 = 32 * (v & 1) + 2 * t4;
        fence_proxy_async();
        if (t == 0) bulk_wait_read();
        bar_sync(3 + c, 128);
        wgmma_wait<2>();
        build_w(f[0], S, cj, ci0, ci1, r0, j0, l0, diag);
        build_w(f[1], S, cj, ci0, ci1, r0, j0 + 8, l0 + 8, diag);
        step3(big, sml, f[0], hi, lo, 0, v == 0);
        step3(big, sml, f[1], hi, lo, 1, false);
        wgmma_wait<2>();
        build_w(f[2], S, cj, ci0, ci1, r0, j0 + 16, l0 + 16, diag);
        build_w(f[3], S, cj, ci0, ci1, r0, j0 + 24, l0 + 24, diag);
        step3(big, sml, f[2], hi, lo, 2, false);
        step3(big, sml, f[3], hi, lo, 3, false);
        if (next) split_item(sm, nkr, nflat, c, nb, t, phase);
      }
      wgmma_wait<0>();                 // the head is done: its 64 x 64
      hold(big);                       // output through the buffer of its
      hold(sml);                       // last item, 128-byte swizzled (two
      float* ob = sm.at<float>(sm.hi(c, (mine - 1) % kSplit));   // 32-p
#pragma unroll                                                   // blocks)
      for (int q = 0; q < 8; ++q) {
        const int col = (8 * q + 2 * t4) & 31, blk = q >> 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          *reinterpret_cast<float2*>(
              ob + blk * (kBlock / 4) + r * 32 +
              ((((col >> 2) ^ (r & 7)) << 2) | (col & 3))) =
              make_float2(big[4 * q + 2 * h] + sml[4 * q + 2 * h],
                          big[4 * q + 2 * h + 1] + sml[4 * q + 2 * h + 1]);
        }
      }
      fence_proxy_async();             // visible to the TMA unit
      bar_sync(3 + c, 128);
      if (t == 0) {                    // rows past Q are clipped by the unit
        const uint32_t src = sm.hi(c, (mine - 1) % kSplit);
        tma_store_4d(to, src, 0, i0, in.h0 + u, it.bc);
        tma_store_4d(to, src + kBlock, 32, i0, in.h0 + u, it.bc);
        bulk_commit();
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.bar(kHeadsDone));
    k += in.n_items;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap to, const SsdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Smem sm{smem_raw + (base - raw), base};
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int r = 0; r < kRaw; ++r) {
      mbar_init(sm.bar(kFull + 2 * r), 1);
      mbar_init(sm.bar(kFull + 2 * r + 1), 1);
      mbar_init(sm.bar(kEmpty + r), 4);
    }
    mbar_init(sm.bar(kCFull), 1);
    mbar_init(sm.bar(kCumFull), 1);
    mbar_init(sm.bar(kScoresDone), 8);
    mbar_init(sm.bar(kHeadsDone), 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the roles never reconverge (setmaxnreg holds for each to its end)
  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    produce(&tx, &tb, &tc, a, sm, tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    consume(&to, a, sm, tid / 128 - 1, tid % 128);
  }
}

cudaError_t launch(const SsdArgs& a, int BC, int blocks, cudaStream_t st) {
  CUtensorMap tx, tb, tc, to;
  const long long xd[4] = {a.P, a.Q, a.H, BC};
  const long long xs[3] = {a.x_sq, a.x_sh, a.x_sb};
  const long long os[3] = {static_cast<long long>(a.H) * a.P, a.P,
                           static_cast<long long>(a.Q) * a.H * a.P};
  const long long bd[3] = {a.N, a.Q, BC};
  const long long bs[2] = {a.b_sq, a.b_sb};
  const long long cs[2] = {a.c_sq, a.c_sb};
  // fp32 boxes of 32 columns with the 128-byte swizzle wgmma reads: 32 x
  // rows, 64 B and C rows, 64 output rows
  const cuuint32_t xbox[4] = {32, 32, 1, 1}, box[3] = {32, 64, 1};
  const cuuint32_t obox[4] = {32, 64, 1, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tx, f32, 4, a.x, 4, xd, xs, xbox, sw) ||
      !tensor_map(&tb, f32, 4, a.B, 3, bd, bs, box, sw) ||
      !tensor_map(&tc, f32, 4, a.C, 3, bd, cs, box, sw) ||
      !tensor_map(&to, f32, 4, a.o, 4, xd, os, obox, sw))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  ssd_wgmma_kernel<<<blocks, kThreads, kSmem, st>>>(tx, tb, tc, to, a);
  return cudaGetLastError();
}

}  // namespace wg

// routes (ssd_scan.py::ROUTES): 0 mma.sync, 1 wgmma (P 64, N 64 or 128)
int route_of(int P, int N) { return P == 64 && (N == 64 || N == 128) ? 1 : 0; }

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// the route the library runs at (P, N), as ssd_scan.py::route gives it
int ssd_scan_route(int P, int N) { return route_of(P, N); }

// the dynamic shared memory of the wgmma route, in bytes
int ssd_scan_wgmma_smem() { return wg::kSmem; }

// x: (BC, Q, H, P), cum: (BC, Q, H), B and C: (BC, Q, N), all float32, read
// through the 10 element strides in `st` (x bc,q,h; cum bc,q,h; B bc,q;
// C bc,q); out: contiguous (BC, Q, H, P). Needs 1 <= Q <= 256 and P, N
// multiples of 4 up to 128. `route` is 0 (mma: any such shape) or 1 (wgmma:
// where route_of(P, N) is 1; the host picks route_of). The wgmma route
// takes `heads` (1..16) heads a work item, windows of `window` chunks,
// `blocks` persistent blocks and `counter`, an int in device memory at 0
// that the blocks draw items from (null: block b takes items b, b +
// blocks, ..). Launches on `stream` and returns cudaGetLastError().
int ssd_scan_launch(const float* x, const float* cum, const float* B,
                    const float* C, float* out, const long long* st, int BC,
                    int Q, int H, int P, int N, int route, int heads,
                    int window, int blocks, int* counter, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 4 || P > kMaxPN || P % 4 || N < 4 ||
      N > kMaxPN || N % 4 || H < 1 || BC < 1 || BC > 65535 ||
      (route != 0 && route != route_of(P, N)))
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a;
  a.x = x; a.cum = cum; a.B = B; a.C = C; a.o = out;
  a.x_sb = st[0]; a.x_sq = st[1]; a.x_sh = st[2];
  a.l_sb = st[3]; a.l_sq = st[4]; a.l_sh = st[5];
  a.b_sb = st[6]; a.b_sq = st[7];
  a.c_sb = st[8]; a.c_sq = st[9];
  a.Q = Q; a.H = H; a.P = P; a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (heads < 1 || heads > wg::kMaxHeads || window < 1 || blocks < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int nT = (Q + wg::kRows - 1) / wg::kRows;
    a.heads_per_block = heads;
    a.BC = BC;
    a.window = window;
    a.total = nT * BC * ((H + heads - 1) / heads);
    a.counter = counter;
    return static_cast<int>(wg::launch(a, BC, blocks, s));
  }
  const int groups = (H + mma::kHeadGroup - 1) / mma::kHeadGroup;
  a.heads_per_block = (H + groups - 1) / groups;
  const cudaError_t err = P <= 16   ? mma::launch_pt<16>(a, BC, s)
                          : P <= 32 ? mma::launch_pt<32>(a, BC, s)
                                    : mma::launch_pt<64>(a, BC, s);
  return static_cast<int>(err);
}

}  // extern "C"
