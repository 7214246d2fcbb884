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
// is ~2.2e10 FLOPs against ~0.69 GB of x, out, cum, B and C. On the CUDA
// cores in fp32 that is bound by operations (0.34 ms at 67 TFLOP/s); the
// first version ran there, as scalar FMAs, at ~5x that. This version puts
// both products on the tensor cores:
//
//   * 3xTF32. mma.sync.m16n8k8 with TF32 operands keeps 10 mantissa bits,
//     ~1e-3 relative, too coarse for the 1e-4 float32 tolerance. Each
//     operand a is split as hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi),
//     and each product is hi.hi + (lo.hi + hi.lo): the large term and the
//     two small ones go to separate fp32 accumulators, added at the end, so
//     the small terms are not rounded against the large running sum (with
//     one accumulator for all three, exploratory builds strayed further from
//     a float64 reference). The dropped lo.lo term is ~2^-22 relative. The scores C . B^T (over N)
//     and W . x (over j) both run this way: 3 x the band's FLOPs at the
//     495 TFLOP/s dense TF32 peak is ~0.13 ms at mamba2's shape, below the
//     0.21 ms the bytes take, so the route's bound is the bytes. mma.sync,
//     not wgmma: its A fragments are built in registers, which is where the
//     decay weights are made and split.
//   * One block of 4 warps per (32-row i tile, group of <= 16 heads, chunk),
//     three blocks an SM (~72 KB of shared memory each): the block computes
//     its rows' scores C_i . B_j for every j tile up to the diagonal once,
//     into shared memory (32 x 260 fp32 at Q = 256), and reuses them for
//     every head of its group (the TPU grid recomputed the whole square per
//     head). Blocks of one (group, chunk) are adjacent in launch order,
//     heaviest i tile first, so they meet their x tiles in L2. Warp w owns
//     rows 16 (w % 2) .. + 16 and a column half (of j in the score pass, of
//     a <= 64-wide column tile of P after it).
//   * Per head, column tile and j tile, each thread builds the decay
//     weights W = scores * 2^((cum_i - cum_j) log2 e) of its own A fragments
//     in registers, in fp32, with j > i (and i >= Q) set to 0 before the
//     exp (ex2.approx, ~2^-22 relative) is taken; a j tile wholly below the
//     block's rows skips the mask, and k steps wholly above a warp's rows
//     are skipped.
//   * B, C, x and cum tiles are copied with cp.async into a double buffer:
//     the next tile's copy is issued before the current tile's products.
//     Rows past the chunk's true Q and columns past N or P are zero-filled
//     by the copy (src-size 0), so a ragged chunk is masked, never padded in
//     memory; x, B and C are read in place through their strides (B and C
//     may be column slices of the model's fused xBC tensor). Row strides of
//     the tiles are 4 (scores, B, C) or 8 (x) floats past a multiple of 32,
//     so every fragment load is free of bank conflicts.
//
// Exploratory builds with 8 or 16 warps a block, the weights or the split x
// tiles kept in shared memory, or a deeper copy pipeline all ran slower:
// with fewer, larger blocks an SM spends its barriers and copy waits idle.
// What bounds this design is the work around the products (the weights,
// the splits, the barriers), not the tensor cores.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBI = 32;         // rows i per block
constexpr int kBJ = 64;         // columns j per tile
constexpr int kBN = 32;         // state columns per step of the score pass
constexpr int kMaxQ = 256;
constexpr int kMaxPN = 128;     // largest head_dim P and state N
constexpr int kHeadGroup = 16;  // most heads per block
constexpr int kCS = kBN + 4;    // row stride of the C and B tiles
constexpr int kStages = 2;      // tiles in flight: copies run a tile ahead
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
};

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

// 2^x, the MUFU approximation (relative error ~2^-22); subnormal results
// flush to 0, where a weight is negligible beside the scores
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// PT: the width of a column tile of x and out (16, 32 or 64); P is walked
// in ceil(P / PT) of them. Warp w owns rows 16 (w % 2) .. + 16 of the block
// and the column half w / 2 (of j in the score pass, of a P tile after).
template <int PT>
__global__ void __launch_bounds__(kThreads, 3) ssd_kernel(const SsdArgs a) {
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
      ssd_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_i = (a.Q + kBI - 1) / kBI;
  const int n_g = (a.H + a.heads_per_block - 1) / a.heads_per_block;
  ssd_kernel<PT><<<dim3(n_i, n_g, BC), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (BC, Q, H, P), cum: (BC, Q, H), B and C: (BC, Q, N), all float32, read
// through the 10 element strides in `st` (x bc,q,h; cum bc,q,h; B bc,q;
// C bc,q); out: contiguous (BC, Q, H, P). Needs 1 <= Q <= 256 and P, N
// multiples of 4 up to 128. Launches on `stream` and returns
// cudaGetLastError().
int ssd_scan_launch(const float* x, const float* cum, const float* B,
                    const float* C, float* out, const long long* st, int BC,
                    int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 4 || P > kMaxPN || P % 4 || N < 4 ||
      N > kMaxPN || N % 4 || H < 1 || BC < 1 || BC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a;
  a.x = x; a.cum = cum; a.B = B; a.C = C; a.o = out;
  a.x_sb = st[0]; a.x_sq = st[1]; a.x_sh = st[2];
  a.l_sb = st[3]; a.l_sq = st[4]; a.l_sh = st[5];
  a.b_sb = st[6]; a.b_sq = st[7];
  a.c_sb = st[8]; a.c_sq = st[9];
  a.Q = Q; a.H = H; a.P = P; a.N = N;
  const int groups = (H + kHeadGroup - 1) / kHeadGroup;
  a.heads_per_block = (H + groups - 1) / groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = P <= 16   ? launch_pt<16>(a, BC, s)
                          : P <= 32 ? launch_pt<32>(a, BC, s)
                                    : launch_pt<64>(a, BC, s);
  return static_cast<int>(err);
}

}  // extern "C"
