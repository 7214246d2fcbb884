// Algorithm-2 swarm replay (paper "map from a particle to DNN layers
// offloading") for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/schedule_sim.py::_schedule_kernel, the Pallas
// TPU kernel behind schedule_replay_folded. It computes the same per-particle
// summary -- (total_cost, feasible, sum of app completion times) -- for every
// particle of a swarm against one padded problem, in both fidelity modes, for
// a fleet of N problems at once.
//
// Design:
//   * Grid (ceil(P / kThreads), N): one thread replays one particle, one
//     fleet problem per blockIdx.y. Tail threads are masked, not padded with
//     copies of a real particle.
//   * Per-particle server state lives in shared memory as [max_S][kThreads]
//     floats (lease, t_on) and [max_apps][kThreads] (running app completion):
//     thread t always hits bank t % 32, whichever server its gene picks, so
//     the data-dependent lease[x[j]] accesses never conflict. The problem's
//     (S, S) link tables are staged in shared memory once per block and read
//     by direct indexed loads (the TPU kernel needed one-hot matrix products
//     there because Mosaic handles gathers poorly).
//   * Genes arrive layer-major, X[n][layer][particle], so a warp's gene loads
//     coalesce. The DAG arrays (order, compute, parent/child ids and MBs,
//     app ids, pins) are the same for every thread and are broadcast loads.
//   * Per-layer end times live in a global scratch buffer of the same
//     layer-major layout (a few MB at the paper's 10,140-layer size; it stays
//     in L2). The faithful recurrence never reads end times, so that mode
//     never writes them.
//   * Every reduction happens inside the walk: app completion is a running
//     max, t_on a running min, the transmission cost and the link/pin flags
//     are registers. max and min do not depend on order, so `feasible` and the
//     completion sum come out exactly as the reference computes them; only the
//     float cost sums may change order.
//
// What bounds it on the card: not bytes and not arithmetic, but the serial
// dependency chain of max_p steps per thread (each step's start time waits
// on the previous lease of its server). One block per problem also leaves
// most of the 132 SMs idle until the fleet axis is wide. Making it fast
// (splitting a swarm across more blocks, prefetching the next steps' genes)
// is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// -Xcompiler -fPIC (kernels/_build.py). --fmad=false keeps every multiply and
// add rounded on its own, as the plain PyTorch version computes them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <bool FAITHFUL>
__global__ void __launch_bounds__(kThreads)
schedule_replay_kernel(const int* __restrict__ X,
                       const int* __restrict__ order,
                       const float* __restrict__ compute,
                       const int* __restrict__ parent_idx,
                       const float* __restrict__ parent_mb,
                       const int* __restrict__ child_idx,
                       const float* __restrict__ child_mb,
                       const int* __restrict__ app_id,
                       const float* __restrict__ deadline,
                       const int* __restrict__ pinned,
                       const float* __restrict__ power,
                       const float* __restrict__ cost_per_sec,
                       const float* __restrict__ inv_bw,
                       const float* __restrict__ tran_cost,
                       const uint8_t* __restrict__ link_ok,
                       float* __restrict__ end,
                       float* __restrict__ total,
                       uint8_t* __restrict__ feasible,
                       float* __restrict__ tsum,
                       int P, int P_pad, int max_p, int max_in, int max_out,
                       int S, int max_apps) {
  extern __shared__ float smem[];
  float* lease = smem;                          // [S][kThreads]
  float* t_on = lease + S * kThreads;           // [S][kThreads]
  float* appc = t_on + S * kThreads;            // [max_apps][kThreads]
  float* s_inv_bw = appc + max_apps * kThreads; // [S][S]
  float* s_tran = s_inv_bw + S * S;             // [S][S]
  float* s_power = s_tran + S * S;              // [S]
  float* s_cost = s_power + S;                  // [S]
  uint8_t* s_link = reinterpret_cast<uint8_t*>(s_cost + S);  // [S][S]

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;

  const size_t SS = static_cast<size_t>(S) * S;
  for (int k = tid; k < S * S; k += kThreads) {
    s_inv_bw[k] = inv_bw[n * SS + k];
    s_tran[k] = tran_cost[n * SS + k];
    s_link[k] = link_ok[n * SS + k];
  }
  for (int k = tid; k < S; k += kThreads) {
    s_power[k] = power[static_cast<size_t>(n) * S + k];
    s_cost[k] = cost_per_sec[static_cast<size_t>(n) * S + k];
  }
  for (int s = 0; s < S; ++s) {
    lease[s * kThreads + tid] = 0.0f;
    t_on[s * kThreads + tid] = INFINITY;
  }
  for (int a = 0; a < max_apps; ++a) appc[a * kThreads + tid] = 0.0f;
  __syncthreads();
  if (i >= P) return;  // no barrier below this line

  const size_t layer0 = static_cast<size_t>(n) * max_p;
  const int* ord = order + layer0;
  const float* comp = compute + layer0;
  const int* pidx = parent_idx + layer0 * max_in;
  const float* pmb = parent_mb + layer0 * max_in;
  const int* cidx = child_idx + layer0 * max_out;
  const float* cmb = child_mb + layer0 * max_out;
  const int* app = app_id + layer0;
  const int* pin = pinned + layer0;
  const int* x = X + layer0 * P_pad + i;        // gene of layer j: x[j * P_pad]
  float* e = end + layer0 * P_pad + i;          // end of layer j: e[j * P_pad]

  float trans = 0.0f;
  bool bad = false;
  bool pin_bad = false;
  for (int t = 0; t < max_p; ++t) {
    const int j = ord[t];
    if (j < 0) continue;                        // padded step: a no-op
    const int srv = x[static_cast<size_t>(j) * P_pad];
    const float exe = comp[j] / s_power[srv];
    float max_trans = 0.0f;
    float gate = 0.0f;
    float tstep = 0.0f;
    for (int k = 0; k < max_in; ++k) {
      const int pj = pidx[j * max_in + k];
      if (pj < 0) continue;
      const float mb = pmb[j * max_in + k];
      const int psrv = x[static_cast<size_t>(pj) * P_pad];
      const float tt = mb * s_inv_bw[psrv * S + srv];
      max_trans = fmaxf(max_trans, tt);
      if (!FAITHFUL) gate = fmaxf(gate, e[static_cast<size_t>(pj) * P_pad] + tt);
      tstep = tstep + s_tran[psrv * S + srv] * mb;
      bad |= (psrv != srv) && !s_link[psrv * S + srv];
    }
    trans = trans + tstep;
    float out_t = 0.0f;
    for (int k = 0; k < max_out; ++k) {
      const int cj = cidx[j * max_out + k];
      if (cj < 0) continue;
      const int csrv = x[static_cast<size_t>(cj) * P_pad];
      out_t = out_t + cmb[j * max_out + k] * s_inv_bw[srv * S + csrv];
      bad |= (csrv != srv) && !s_link[srv * S + csrv];
    }
    const float lease_srv = lease[srv * kThreads + tid];
    float start, new_lease;
    if (FAITHFUL) {
      start = lease_srv + max_trans;
      new_lease = (lease_srv + exe) + out_t;
    } else {
      start = fmaxf(lease_srv, gate);
      new_lease = (start + exe) + out_t;
    }
    const float t_end = start + exe;
    lease[srv * kThreads + tid] = new_lease;
    t_on[srv * kThreads + tid] = fminf(t_on[srv * kThreads + tid], start);
    const int a = app[j];
    appc[a * kThreads + tid] = fmaxf(appc[a * kThreads + tid], t_end);
    if (!FAITHFUL) e[static_cast<size_t>(j) * P_pad] = t_end;
    pin_bad |= (pin[j] >= 0) && (srv != pin[j]);
  }

  float comp_cost = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float on = t_on[s * kThreads + tid];
    if (on != INFINITY) comp_cost = comp_cost + s_cost[s] * (lease[s * kThreads + tid] - on);
  }
  const float* dl = deadline + static_cast<size_t>(n) * max_apps;
  bool deadline_ok = true;
  float completion = 0.0f;
  for (int a = 0; a < max_apps; ++a) {
    const float c = appc[a * kThreads + tid];
    deadline_ok &= c <= dl[a];
    completion = completion + c;
  }
  const size_t out = static_cast<size_t>(n) * P + i;
  total[out] = comp_cost + trans;
  feasible[out] = deadline_ok && !pin_bad && !bad;
  tsum[out] = completion;
}

}  // namespace

extern "C" {

size_t schedule_replay_smem_bytes(int S, int max_apps) {
  return sizeof(float) * (static_cast<size_t>(2 * S + max_apps) * kThreads
                          + 2 * static_cast<size_t>(S) * S + 2 * S)
         + static_cast<size_t>(S) * S;
}

const char* schedule_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the replay on `stream` and returns cudaGetLastError(). Every
// pointer is device memory laid out as documented in kernels/schedule_sim.py.
int schedule_replay_launch(const int* X, const int* order, const float* compute,
                           const int* parent_idx, const float* parent_mb,
                           const int* child_idx, const float* child_mb,
                           const int* app_id, const float* deadline,
                           const int* pinned, const float* power,
                           const float* cost_per_sec, const float* inv_bw,
                           const float* tran_cost, const uint8_t* link_ok,
                           float* end, float* total, uint8_t* feasible,
                           float* tsum, int N, int P, int P_pad, int max_p,
                           int max_in, int max_out, int S, int max_apps,
                           int faithful, void* stream) {
  const size_t smem = schedule_replay_smem_bytes(S, max_apps);
  const dim3 grid((P + kThreads - 1) / kThreads, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (faithful) {
    err = cudaFuncSetAttribute(schedule_replay_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    schedule_replay_kernel<true><<<grid, kThreads, smem, st>>>(
        X, order, compute, parent_idx, parent_mb, child_idx, child_mb, app_id,
        deadline, pinned, power, cost_per_sec, inv_bw, tran_cost, link_ok, end,
        total, feasible, tsum, P, P_pad, max_p, max_in, max_out, S, max_apps);
  } else {
    err = cudaFuncSetAttribute(schedule_replay_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    schedule_replay_kernel<false><<<grid, kThreads, smem, st>>>(
        X, order, compute, parent_idx, parent_mb, child_idx, child_mb, app_id,
        deadline, pinned, power, cost_per_sec, inv_bw, tran_cost, link_ok, end,
        total, feasible, tsum, P, P_pad, max_p, max_in, max_out, S, max_apps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
