// Intra-chunk SSD quadratic form of Mamba2 for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel repro/kernels/ssd_scan.py (_ssd_kernel,
// called through ssd_intra_folded). For every chunk bc, row i < Q and head h,
//
//     out[bc, i, h, :] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * x[bc, j, h, :]
//
// in float32. Entries with j > i are skipped, never multiplied by a mask:
// there cum_i - cum_j >= 0 can be large and exp of it is inf.
//
// What bounds it on the H100: at mamba2-2.7b's serving shape (BC = 64
// chunks of Q = 256, H = 80 heads of P = 64, state N = 128) the causal band
// is ~2.2e10 FLOPs against ~0.69 GB of x, out, cum, B and C, above the
// card's ridge point, so it is bound by operations. The float32 tolerance
// (1e-4) rules out TF32 products, so this first version does scalar fp32
// FMAs on the CUDA cores. Its design, to do no more arithmetic than the band:
//
//   * the TPU grid is (chunk, head) and every cell recomputes the (Q, Q)
//     product C . B^T although B and C do not depend on the head, and works
//     the whole square although half of it is masked. Here one block of 256
//     threads owns a (64-row i tile, group of up to 16 heads, chunk): it
//     computes the scores C_i . B_j of its rows for j up to the tile's last
//     row once, keeps them in shared memory (64 x 256 fp32 = 65 KB at
//     Q = 256), and reuses them for every head of its group;
//   * per head, each 64-column j tile at or below the diagonal is turned into
//     weights W = scores * exp(cum_i - cum_j) (0 above the diagonal) in shared
//     memory beside the x tile, and W . x accumulates in registers: each
//     thread owns 4 rows x 4 (or 8) columns of the output;
//   * i tiles are issued heaviest first (the last tile meets Q / 64 j tiles),
//     so the tail of the grid is short; ~100 KB of shared memory per block at
//     the serving shape lets two blocks share an SM;
//   * x, B and C are read in place through element strides (B and C may be
//     column slices of the model's fused xBC tensor); the ragged end of a
//     chunk shorter than 64 rows is masked with the true Q, nothing padded.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBI = 64;         // rows i per block
constexpr int kBJ = 64;         // columns j per tile
constexpr int kBN = 32;         // state columns per pass of the score product
constexpr int kMaxQ = 256;
constexpr int kMaxPN = 128;     // largest head_dim P and state N
constexpr int kHeadGroup = 16;  // most heads per block
constexpr int kCS = kBN + 4;    // padded row stride of sC and sB
constexpr int kWS = kBJ + 4;    // padded row stride of sW

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

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ constexpr int score_stride(int q) {
  return (q + kBJ - 1) / kBJ * kBJ + 4;
}

// shared floats: scores, then a region used first by sC / sB (score pass)
// and then by sW / sX (head pass), then the cum rows of one head
__host__ __device__ constexpr int smem_floats(int q, int p) {
  return kBI * score_stride(q) +
         (2 * kBI * kCS > kBI * kWS + kBJ * p ? 2 * kBI * kCS
                                               : kBI * kWS + kBJ * p) +
         kBI + (q + kBJ - 1) / kBJ * kBJ;
}

// NV: output float4 columns per thread (P <= 64: 1, P <= 128: 2)
template <int NV>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int SS = score_stride(Q);
  float* sS = smem;                        // [kBI][SS] scores C_i . B_j
  float* sU = sS + kBI * SS;
  float* sC = sU;                          // [kBI][kCS] score pass
  float* sB = sC + kBI * kCS;              // [kBJ][kCS]
  float* sW = sU;                          // [kBI][kWS] head pass
  float* sX = sW + kBI * kWS;              // [kBJ][P]
  float* sLi = sU + (2 * kBI * kCS > kBI * kWS + kBJ * P ? 2 * kBI * kCS
                                                         : kBI * kWS + kBJ * P);
  float* sLj = sLi + kBI;                  // cum of this head, every j

  const int t = gridDim.x - 1 - blockIdx.x;  // heaviest i tiles first
  const int h0 = blockIdx.y * a.heads_per_block;
  const int bc = blockIdx.z;
  const int i0 = t * kBI;
  const int jlim = min((t + 1) * kBJ, Q);    // columns j this block meets
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const float* Bp = a.B + bc * a.b_sb;
  const float* Cp = a.C + bc * a.c_sb;

  // 1. scores of rows i0 .. i0+63 against every j tile up to the diagonal:
  //    rows 4*ty + r, columns tx + 16*c of each 64 x 64 tile
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * kBJ;
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kBN) {
      __syncthreads();                     // the last pass's sC / sB are read
      for (int e = tid; e < kBI * (kBN / 4); e += kThreads) {
        const int r = e / (kBN / 4), n = n0 + (e % (kBN / 4)) * 4;
        float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
        if (n < N) {
          if (i0 + r < Q)
            cv = *reinterpret_cast<const float4*>(
                Cp + (long long)(i0 + r) * a.c_sq + n);
          if (j0 + r < Q)
            bv = *reinterpret_cast<const float4*>(
                Bp + (long long)(j0 + r) * a.b_sq + n);
        }
        *reinterpret_cast<float4*>(sC + r * kCS + (n - n0)) = cv;
        *reinterpret_cast<float4*>(sB + r * kCS + (n - n0)) = bv;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kBN; d += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(sC + (4 * ty + r) * kCS + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(sB + (tx + 16 * c) * kCS + d);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fma4(cv[r], bv[c], s[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sS[(4 * ty + r) * SS + j0 + tx + 16 * c] = s[r][c];
  }

  // 2. every head of the group reuses the scores
  const int h1 = min(h0 + a.heads_per_block, a.H);
  for (int h = h0; h < h1; ++h) {
    __syncthreads();                       // scores written; last head done
    const float* lp = a.cum + bc * a.l_sb + h * a.l_sh;
    for (int j = tid; j < jlim; j += kThreads) sLj[j] = lp[j * a.l_sq];
    for (int r = tid; r < kBI; r += kThreads)
      sLi[r] = i0 + r < Q ? lp[(i0 + r) * a.l_sq] : 0.f;
    const float* xp = a.x + bc * a.x_sb + h * a.x_sh;

    float acc[4][NV][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;

    for (int jt = 0; jt <= t; ++jt) {
      const int j0 = jt * kBJ;
      __syncthreads();                     // cum rows in; last tile consumed
      // weights: exp only where j <= i (and i < Q, hence j < Q)
      for (int e = tid; e < kBI * kBJ; e += kThreads) {
        const int r = e / kBJ, c = e % kBJ;
        const int i = i0 + r, j = j0 + c;
        float w = 0.f;
        if (j <= i && i < Q) w = sS[r * SS + j] * expf(sLi[r] - sLj[j]);
        sW[r * kWS + c] = w;
      }
      const int P4 = P / 4;
      for (int e = tid; e < kBJ * P4; e += kThreads) {
        const int r = e / P4, c = (e % P4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + r < Q)
          v = *reinterpret_cast<const float4*>(xp + (long long)(j0 + r) * a.x_sq + c);
        *reinterpret_cast<float4*>(sX + r * P + c) = v;
      }
      __syncthreads();

      // acc += W . x over this tile: output columns 4 * (tx + 16 * c) .. +3
#pragma unroll 2
      for (int kk = 0; kk < kBJ; kk += 4) {
        float4 wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wv[r] = *reinterpret_cast<const float4*>(sW + (4 * ty + r) * kWS + kk);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int col = 4 * (tx + 16 * c);
          if (col < P) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 xv = *reinterpret_cast<const float4*>(sX + (kk + u) * P + col);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float w = u == 0 ? wv[r].x : u == 1 ? wv[r].y
                              : u == 2 ? wv[r].z : wv[r].w;
                acc[r][c][0] = fmaf(w, xv.x, acc[r][c][0]);
                acc[r][c][1] = fmaf(w, xv.y, acc[r][c][1]);
                acc[r][c][2] = fmaf(w, xv.z, acc[r][c][2]);
                acc[r][c][3] = fmaf(w, xv.w, acc[r][c][3]);
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      if (i >= Q) continue;
      float* op = a.o + (((long long)bc * Q + i) * a.H + h) * P;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = 4 * (tx + 16 * c);
        if (col < P)
          *reinterpret_cast<float4*>(op + col) =
              make_float4(acc[r][c][0], acc[r][c][1], acc[r][c][2], acc[r][c][3]);
      }
    }
  }
}

template <int NV>
cudaError_t launch_nv(const SsdArgs& a, int BC, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(a.Q, a.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_i = (a.Q + kBI - 1) / kBI;
  const int n_g = (a.H + a.heads_per_block - 1) / a.heads_per_block;
  ssd_kernel<NV><<<dim3(n_i, n_g, BC), kThreads, smem, st>>>(a);
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
  const cudaError_t err =
      P <= 64 ? launch_nv<1>(a, BC, s) : launch_nv<2>(a, BC, s);
  return static_cast<int>(err);
}

}  // extern "C"
