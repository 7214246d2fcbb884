// What the two replay kernels share (schedule_sim.cu, B1, and traffic_sim.cu,
// B2): the walk's geometry, the cp.async helpers, and the carry-free first
// pass of kernels/schedule_sim.py::phase1.
//
// The carry-free pass runs over every (problem, topo position t, particle)
// and writes, step-major as planes[n][field][t][i] (a 128-byte row per
// field for 32 particles), the step's server, execution time, outgoing
// transfer time and transmission $, then max_trans (faithful mode) or one
// transfer time tt per parent slot (corrected mode). Each particle's
// forbidden links (bit 0) and broken pins (bit 1) are OR-ed per chunk of
// kChunk steps into flags[n][chunk][i]. Sums run over parents, then
// children, in slot order, as the plain version's. B1's walk reads row t at
// step t; B2's walk reads, at each merged step, the row of its layer's topo
// position. Each .cu file wraps pass_body in a __global__ of its own name,
// so a profile tells the two kernels apart.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;        // particles per walk block (one warp)
constexpr int kT = 16;            // steps per tile of the walk's buffers
constexpr int kAhead = 3;         // tiles whose copies are in flight
constexpr int kPlaneStages = kAhead + 1;
constexpr int kMetaStages = 2 * kAhead + 1;  // step tables run kAhead further
constexpr int kW = 64;            // ring of parents' end times, in steps
constexpr int kMaxIn = 8;         // parent slots the walk takes
constexpr int kChunk = 128;       // steps per carry-free pass block
constexpr int kStepWarps = 8;     // carry-free pass warps per block
static_assert(kW >= (kAhead + 1) * kT,
              "a far read must be final when it is copied, kAhead tiles ahead");
static_assert((kW & (kW - 1)) == 0, "the ring is indexed by a mask");

// Planes per step: srv, exe, out_t, tstep, then max_trans (faithful) or one
// transfer time per parent slot (corrected).
__host__ __device__ constexpr int pass_fields(int max_in, bool faithful) {
  return faithful ? 5 : 4 + max_in;
}

struct PassArgs {
  const int* X;             // (N, P, max_p) genes
  const int* order;         // (N, max_p)
  const float* compute;     // (N, max_p)
  const int* parent_idx;    // (N, max_p, max_in)
  const float* parent_mb;
  const int* child_idx;     // (N, max_p, max_out)
  const float* child_mb;
  const int* pinned;        // (N, max_p)
  const float* power;       // (N, S)
  const float* inv_bw;      // (N, S, S)
  const float* tran_cost;
  const uint8_t* link_ok;
  float* planes;            // (N, F, rows, P_pad), rows >= max_p
  uint8_t* flags;           // (N, n_chunks, P_pad)
  int P, P_pad, max_p, rows, max_in, max_out, S, F, n_chunks;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The carry-free pass, one block of kStepWarps warps per (32 particles,
// chunk of kChunk steps, problem): grid (P_pad / 32, n_chunks, N).
template <bool FAITHFUL>
__device__ __forceinline__ void pass_body(const PassArgs& a) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kLanes + lane;
  const int chunk = blockIdx.y, n = blockIdx.z;
  const int S = a.S, max_in = a.max_in, max_out = a.max_out;
  const size_t SS = static_cast<size_t>(S) * S;
  const float* inv_bw = a.inv_bw + n * SS;
  const float* tran = a.tran_cost + n * SS;
  const uint8_t* link = a.link_ok + n * SS;
  const float* power = a.power + static_cast<size_t>(n) * S;
  const size_t layer0 = static_cast<size_t>(n) * a.max_p;
  const int* ord = a.order + layer0;
  const float* comp = a.compute + layer0;
  const int* pidx = a.parent_idx + layer0 * max_in;
  const float* pmb = a.parent_mb + layer0 * max_in;
  const int* cidx = a.child_idx + layer0 * max_out;
  const float* cmb = a.child_mb + layer0 * max_out;
  const int* pin = a.pinned + layer0;
  // lanes past P replay gene 0 everywhere: harmless, and never written out
  const bool live = i < a.P;
  const int* x = a.X + (static_cast<size_t>(n) * a.P + (live ? i : 0)) * a.max_p;
  const size_t plane = static_cast<size_t>(a.rows) * a.P_pad;

  unsigned flag = 0;                    // bit 0: forbidden link, bit 1: pin
  for (int s = 0; s < kChunk / kStepWarps; ++s) {
    const int t = chunk * kChunk + s * kStepWarps + w;
    if (t >= a.max_p) break;
    // the pin of gene t, padded layers included (the plain pin_ok's scope)
    if (pin[t] >= 0 && (live ? __ldg(x + t) : 0) != pin[t]) flag |= 2u;
    const int j = ord[t];
    if (j < 0) continue;                // padded step: the walk skips it
    const int srv = live ? __ldg(x + j) : 0;
    const float exe = comp[j] / power[srv];
    float* pl = a.planes + static_cast<size_t>(n) * a.F * plane +
                static_cast<size_t>(t) * a.P_pad + i;
    float max_trans = 0.0f, tstep = 0.0f;
    for (int k = 0; k < max_in; ++k) {
      const int pj = pidx[j * max_in + k];
      float tt = 0.0f;
      if (pj >= 0) {
        const float mb = pmb[j * max_in + k];
        const int psrv = live ? __ldg(x + pj) : 0;
        tt = mb * __ldg(inv_bw + psrv * S + srv);
        max_trans = fmaxf(max_trans, tt);
        tstep = tstep + __ldg(tran + psrv * S + srv) * mb;
        if (psrv != srv && !__ldg(link + psrv * S + srv)) flag |= 1u;
      }
      if (!FAITHFUL) pl[(4 + k) * plane] = tt;
    }
    float out_t = 0.0f;
    for (int k = 0; k < max_out; ++k) {
      const int cj = cidx[j * max_out + k];
      if (cj < 0) continue;
      const int csrv = live ? __ldg(x + cj) : 0;
      out_t = out_t + cmb[j * max_out + k] * __ldg(inv_bw + srv * S + csrv);
      if (csrv != srv && !__ldg(link + srv * S + csrv)) flag |= 1u;
    }
    pl[0] = __int_as_float(srv);
    pl[plane] = exe;
    pl[2 * plane] = out_t;
    pl[3 * plane] = tstep;
    if (FAITHFUL) pl[4 * plane] = max_trans;
  }
  __shared__ unsigned s_flag[kStepWarps][32];
  s_flag[w][lane] = flag;
  __syncthreads();
  if (w == 0) {
    for (int v = 1; v < kStepWarps; ++v) flag |= s_flag[v][lane];
    a.flags[(static_cast<size_t>(n) * a.n_chunks + chunk) * a.P_pad + i] =
        static_cast<uint8_t>(flag);
  }
}

inline dim3 pass_grid(const PassArgs& a, int N) {
  return dim3(a.P_pad / kLanes, a.n_chunks, N);
}

}  // namespace
