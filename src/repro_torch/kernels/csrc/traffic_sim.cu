// Queue-aware FCFS traffic replay (DESIGN.md §10) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/traffic_sim.py::_traffic_kernel, the Pallas
// TPU kernel behind traffic_replay_folded. R request copies of every
// particle's schedule are replayed against shared per-server FCFS queues in
// the merged (arrival, request slot, topo position) order; per particle and
// per Monte-Carlo arrival draw it returns the load-adjusted cost, the
// deadline-miss rate and the latency sum, per particle the static
// feasibility (pins honoured, links legal), and optionally the latency of
// every (app, request).
//
// Design:
//   * Grid (ceil(P / kThreads), M, N): one thread replays one particle, one
//     arrival draw per blockIdx.y, one fleet problem per blockIdx.z. The
//     merged order is built once per solve on the host side (padding and
//     +inf requests sorted past n_valid), so each block walks exactly its own
//     n_valid[n][m] real steps; no lane waits for the longest draw.
//   * A step is one (request r, layer j) pair, given as slot = r*max_p + j
//     and its arrival time. The per-step quantities (execution time,
//     transfer times, transmission cost) are computed inside the walk from
//     the genes, as the zero-load kernel does, so the host never builds
//     (P, max_p, max_in) phase-1 tensors.
//   * Per-particle server state lives in shared memory as [S][kThreads]
//     (lease, t_on), and the running completion of every (app, request) as
//     [max_apps * R][kThreads]: thread t always hits bank t % 32. The (S, S)
//     link tables are staged in shared memory once per block.
//   * Genes arrive layer-major, X[n][layer][particle], so a warp's gene loads
//     coalesce. The per-(request, layer) end times the parent gate reads are
//     R * max_p floats per particle, more than a block's shared memory holds
//     at real sizes, so they live in a global scratch of the same layer-major
//     layout, [n][m][slot][particle], which stays in L2. The faithful
//     recurrence never reads end times and never writes them.
//   * Static feasibility does not depend on the arrivals: the m == 0 block
//     of each particle tile computes it in a pass over every valid layer,
//     walked or not.
//
// What bounds it on the card: not bytes and not arithmetic, but the serial
// dependency chain of n_valid steps per thread (each start time waits on the
// lease of its server). M * N blocks of one tile each leave most SMs idle at
// the planner's sizes; making it fast is later work.
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
traffic_replay_kernel(const int* __restrict__ X,
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
                      const int* __restrict__ slot_m,
                      const float* __restrict__ arr_m,
                      const int* __restrict__ n_valid,
                      const float* __restrict__ arr2,
                      const uint8_t* __restrict__ req_valid,
                      float* __restrict__ end,
                      float* __restrict__ total,
                      float* __restrict__ miss_rate,
                      float* __restrict__ lat_sum,
                      uint8_t* __restrict__ static_ok,
                      float* __restrict__ latency,
                      int P, int P_pad, int max_p, int max_in, int max_out,
                      int S, int max_apps, int R) {
  extern __shared__ float smem[];
  const int AR = max_apps * R;
  float* lease = smem;                          // [S][kThreads]
  float* t_on = lease + S * kThreads;           // [S][kThreads]
  float* appc = t_on + S * kThreads;            // [max_apps * R][kThreads]
  float* s_inv_bw = appc + AR * kThreads;       // [S][S]
  float* s_tran = s_inv_bw + S * S;             // [S][S]
  float* s_power = s_tran + S * S;              // [S]
  float* s_cost = s_power + S;                  // [S]
  uint8_t* s_link = reinterpret_cast<uint8_t*>(s_cost + S);  // [S][S]

  const int m = blockIdx.y;
  const int n = blockIdx.z;
  const int M = gridDim.y;
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
  for (int k = 0; k < AR; ++k) appc[k * kThreads + tid] = 0.0f;
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

  // ---- static feasibility: every valid layer, once per particle ----------
  if (m == 0) {
    bool bad = false;
    for (int t = 0; t < max_p; ++t) {
      const int j = ord[t];
      if (j < 0) continue;
      const int srv = x[static_cast<size_t>(j) * P_pad];
      for (int k = 0; k < max_in; ++k) {
        const int pj = pidx[j * max_in + k];
        if (pj < 0) continue;
        const int psrv = x[static_cast<size_t>(pj) * P_pad];
        bad |= (psrv != srv) && !s_link[psrv * S + srv];
      }
      for (int k = 0; k < max_out; ++k) {
        const int cj = cidx[j * max_out + k];
        if (cj < 0) continue;
        const int csrv = x[static_cast<size_t>(cj) * P_pad];
        bad |= (csrv != srv) && !s_link[srv * S + csrv];
      }
    }
    for (int j = 0; j < max_p; ++j)             // every gene, padding too
      bad |= (pin[j] >= 0) && (x[static_cast<size_t>(j) * P_pad] != pin[j]);
    static_ok[static_cast<size_t>(n) * P + i] = !bad;
  }

  // ---- the merged walk: this draw's n_valid real steps --------------------
  const size_t lane = static_cast<size_t>(n) * M + m;
  const size_t T = static_cast<size_t>(R) * max_p;
  const int* slots = slot_m + lane * T;
  const float* arrs = arr_m + lane * T;
  float* e = end + lane * T * P_pad + i;        // end of slot s: e[s * P_pad]
  const int steps = n_valid[lane];

  float trans = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const int slot = slots[t];
    const float a = arrs[t];
    const int r = slot / max_p;
    const int j = slot - r * max_p;
    const int slot0 = slot - j;
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
      if (!FAITHFUL)
        gate = fmaxf(gate, e[static_cast<size_t>(slot0 + pj) * P_pad] + tt);
      tstep = tstep + s_tran[psrv * S + srv] * mb;
    }
    trans = trans + tstep;
    float out_t = 0.0f;
    for (int k = 0; k < max_out; ++k) {
      const int cj = cidx[j * max_out + k];
      if (cj < 0) continue;
      const int csrv = x[static_cast<size_t>(cj) * P_pad];
      out_t = out_t + cmb[j * max_out + k] * s_inv_bw[srv * S + csrv];
    }
    const float lease_srv = lease[srv * kThreads + tid];
    float start, new_lease;
    if (FAITHFUL) {
      const float base = fmaxf(lease_srv, a);
      start = base + max_trans;
      new_lease = (base + exe) + out_t;
    } else {
      start = fmaxf(lease_srv, fmaxf(gate, a));
      new_lease = (start + exe) + out_t;
    }
    const float t_end = start + exe;
    lease[srv * kThreads + tid] = new_lease;
    t_on[srv * kThreads + tid] = fminf(t_on[srv * kThreads + tid], start);
    const int c = app[j] * R + r;
    appc[c * kThreads + tid] = fmaxf(appc[c * kThreads + tid], t_end);
    if (!FAITHFUL) e[static_cast<size_t>(slot) * P_pad] = t_end;
  }

  // ---- epilogue: apps, then requests, in that order -----------------------
  float comp_cost = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float on = t_on[s * kThreads + tid];
    if (on != INFINITY)
      comp_cost = comp_cost + s_cost[s] * (lease[s * kThreads + tid] - on);
  }
  const float* dl = deadline + static_cast<size_t>(n) * max_apps;
  const float* a2 = arr2 + lane * AR;
  const uint8_t* rv = req_valid + lane * AR;
  float* lat_out = latency == nullptr ? nullptr
                   : latency + (lane * P + i) * AR;
  float misses = 0.0f;
  float lsum = 0.0f;
  float n_req = 0.0f;
  for (int a = 0; a < max_apps; ++a) {
    for (int r = 0; r < R; ++r) {
      const int c = a * R + r;
      const bool real = rv[c] != 0;
      const float lat = real ? appc[c * kThreads + tid] - a2[c] : 0.0f;
      if (lat_out != nullptr) lat_out[c] = lat;
      if (real && lat > dl[a]) misses = misses + 1.0f;
      lsum = lsum + lat;
      if (real) n_req = n_req + 1.0f;
    }
  }
  const size_t out = lane * P + i;
  total[out] = comp_cost + trans;
  miss_rate[out] = misses / fmaxf(n_req, 1.0f);
  lat_sum[out] = lsum;
}

}  // namespace

extern "C" {

size_t traffic_replay_smem_bytes(int S, int max_apps, int R) {
  return sizeof(float) * (static_cast<size_t>(2 * S + max_apps * R) * kThreads
                          + 2 * static_cast<size_t>(S) * S + 2 * S)
         + static_cast<size_t>(S) * S;
}

const char* traffic_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the replay on `stream` and returns cudaGetLastError(). Every
// pointer is device memory laid out as documented in kernels/traffic_sim.py;
// `latency` may be null (the grid is then not written).
int traffic_replay_launch(const int* X, const int* order, const float* compute,
                          const int* parent_idx, const float* parent_mb,
                          const int* child_idx, const float* child_mb,
                          const int* app_id, const float* deadline,
                          const int* pinned, const float* power,
                          const float* cost_per_sec, const float* inv_bw,
                          const float* tran_cost, const uint8_t* link_ok,
                          const int* slot_m, const float* arr_m,
                          const int* n_valid, const float* arr2,
                          const uint8_t* req_valid, float* end, float* total,
                          float* miss_rate, float* lat_sum,
                          uint8_t* static_ok, float* latency, int N, int M,
                          int P, int P_pad, int max_p, int max_in,
                          int max_out, int S, int max_apps, int R,
                          int faithful, void* stream) {
  const size_t smem = traffic_replay_smem_bytes(S, max_apps, R);
  const dim3 grid((P + kThreads - 1) / kThreads, M, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (faithful) {
    err = cudaFuncSetAttribute(traffic_replay_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    traffic_replay_kernel<true><<<grid, kThreads, smem, st>>>(
        X, order, compute, parent_idx, parent_mb, child_idx, child_mb, app_id,
        deadline, pinned, power, cost_per_sec, inv_bw, tran_cost, link_ok,
        slot_m, arr_m, n_valid, arr2, req_valid, end, total, miss_rate,
        lat_sum, static_ok, latency, P, P_pad, max_p, max_in, max_out, S,
        max_apps, R);
  } else {
    err = cudaFuncSetAttribute(traffic_replay_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    traffic_replay_kernel<false><<<grid, kThreads, smem, st>>>(
        X, order, compute, parent_idx, parent_mb, child_idx, child_mb, app_id,
        deadline, pinned, power, cost_per_sec, inv_bw, tran_cost, link_ok,
        slot_m, arr_m, n_valid, arr2, req_valid, end, total, miss_rate,
        lat_sum, static_ok, latency, P, P_pad, max_p, max_in, max_out, S,
        max_apps, R);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
