// Algorithm-2 swarm replay (paper "map from a particle to DNN layers
// offloading") for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/schedule_sim.py::_schedule_kernel, the Pallas
// TPU kernel behind schedule_replay_folded. It computes the same per-particle
// summary -- (total_cost, feasible, sum of app completion times) -- for every
// particle of a swarm against one padded problem, in both fidelity modes, for
// a fleet of N problems at once.
//
// What bounds it: not bytes and not arithmetic, but the serial chain of
// max_p steps per particle (a step's start waits on the lease of its server
// and, in corrected mode, on its parents' end times). The first version put
// every global load of a step (order, compute, relatives, genes, end times)
// on that chain, ~1,600 cycles a step, and ran a pop-100 swarm in one block.
// This design takes everything that does not depend on the carry off it:
//
//   * Two launches per call. schedule_step_kernel is the carry-free first
//     pass of kernels/schedule_sim.py::phase1 (pass_body, shared with B2 in
//     replay_common.cuh): for every (problem, step, particle) it writes the
//     step's server, execution time, outgoing transfer time, transmission $
//     and either max_trans (faithful) or each parent slot's transfer time tt
//     (corrected), step-major as planes[n][field][t][i], and ORs each
//     particle's forbidden-link / pin flags per chunk of 128 steps.
//     It runs over every SM (blocks of 8 warps x 32 particles x 128 steps).
//     A separate kernel, not producer warps inside the walk's block: the
//     pass is ~10,000 independent gathers per particle at Fig. 8 and wants
//     the whole card, while the walk wants few, small blocks; and the planes
//     (~31 MB at Fig. 8) stay in the 50 MB L2 between the two launches.
//   * schedule_walk_kernel carries the recurrence, one warp per block, one
//     particle per lane, so pop 100 spans 4 blocks on 4 SMs (the fleet adds
//     more). It reads the planes through a cp.async ring of kT = 16-step
//     tiles, kAhead = 3 tiles in flight, so the copies' latency stays off
//     the chain. The per-step tables that every particle shares (valid bit,
//     app id, "end is read beyond the ring" bit, each parent's step distance,
//     and per tile "every step is real" and "reads beyond the ring") come
//     through a second ring that runs kAhead tiles further ahead.
//   * A single warp issues in order, so every shared-memory load consumed
//     right away stalls it. The walk takes 8 steps' carry-free values into
//     registers at a time, before any of their stores, and reads the next
//     step's lease and its parents' ring slots before the current step's
//     stores (forwarding the lease when both steps use the same server). A
//     tile whose steps are all real, and that reads nothing beyond the ring,
//     runs without a branch per step: ring slots are read whatever the
//     distance and selected afterwards.
//   * Parents' end times: the previous step's end sits in a register (most
//     edges of the zoo DAGs are one step long); older ends live in a
//     per-lane ring of the last kW = 64 ends in shared memory, indexed by
//     step. The wrapper computes the distances once per problem
//     (kernels/schedule_sim.py::step_tables). A step whose end is read more
//     than kW steps later also stores it to far_end in global memory, and the
//     walk copies those reads into shared memory (cp.async) with the tile
//     kAhead tiles ahead: with kW >= (kAhead + 1) kT every such value was
//     final before the copy is issued. Faithful mode reads no ends: no ring.
//   * A step's chain is then the gate (an add and a max per parent), a max
//     against the lease, the adds for the end and the new lease, and a
//     store. The app's completion is a running max in a register while the
//     app stays the same (the app is the same for every lane); in corrected
//     mode a server's starts never decrease, so t_on is stored once, at its
//     first use, tracked by a bit per server (S <= 64). Server state is
//     [S][32 lanes], so lane l always hits bank l whatever server its gene
//     picks.
//
// Numbers: every float sum keeps the plain version's order (steps, then
// parents or children, then servers, then apps) and every product and
// quotient is rounded on its own (--fmad=false), so totals, `feasible` and
// completion sums equal kernels/schedule_sim.py::schedule_replay_plain's bit
// for bit; max and min are order-free.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// -Xcompiler -fPIC (kernels/_build.py).

#include <type_traits>

#include "replay_common.cuh"

namespace {

// B1's arguments: the carry-free pass's (rows = max_p_pad), then the walk's.
struct Args : PassArgs {
  const float* deadline;    // (N, max_apps)
  const float* cost_per_sec;  // (N, S)
  const int* meta;          // (N, max_p_pad, 1 + max_in) step tables
  float* far_end;           // (N, max_p_pad, P_pad), corrected mode
  float* total;             // (N, P)
  uint8_t* feasible;
  float* tsum;
  int max_p_pad, max_apps;
};

// ---------------------------------------------------------------------------
// pass 1: the carry-free quantities of every (step, particle)
// ---------------------------------------------------------------------------
template <bool FAITHFUL>
__global__ void __launch_bounds__(kStepWarps * 32)
schedule_step_kernel(const PassArgs a) {
  pass_body<FAITHFUL>(a);
}

// ---------------------------------------------------------------------------
// pass 2: the carried walk
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t walk_smem_floats(int F, int max_in, int S,
                                                      int max_apps,
                                                      bool faithful) {
  return static_cast<size_t>(kPlaneStages * F * kT * kLanes)      // planes
         + (faithful ? 0 : kPlaneStages * kT * max_in * kLanes    // far reads
                               + kW * kLanes)                     // ring
         + static_cast<size_t>(2 * S + max_apps) * kLanes         // lease t_on appc
         + kMetaStages * kT * (1 + max_in);                       // step tables
}

// MAXIN: the parent slots a step's registers hold (>= max_in); the walk
// takes kB steps' carry-free values into registers at a time. TMASK
// (corrected mode, S <= 64): t_on is stored once, at a server's first use.
template <bool FAITHFUL, int MAXIN, bool TMASK>
__global__ void __launch_bounds__(kLanes) schedule_walk_kernel(const Args a) {
  constexpr int kB = MAXIN <= 4 ? 8 : 4;
  static_assert(kT % kB == 0, "a tile holds whole batches");
  extern __shared__ __align__(16) float smem[];
  const int F = a.F, max_in = a.max_in, MS = 1 + max_in;
  float* s_planes = smem;                                 // [stage][F][kT][32]
  float* s_far = s_planes + kPlaneStages * F * kT * kLanes;  // [stage][kT][max_in][32]
  float* s_ring = s_far + (FAITHFUL ? 0 : kPlaneStages * kT * max_in * kLanes);
  float* s_lease = s_ring + (FAITHFUL ? 0 : kW * kLanes);  // [S][32]
  float* s_t_on = s_lease + a.S * kLanes;                 // [S][32]
  float* s_appc = s_t_on + a.S * kLanes;                  // [max_apps][32]
  int* s_meta = reinterpret_cast<int*>(s_appc + a.max_apps * kLanes);  // [stage][kT][MS]

  const int lane = threadIdx.x;
  // this lane's column of the per-particle state
  float* const ring = s_ring + lane;                      // [kW] by step
  float* const lease = s_lease + lane;                    // [S] by server
  float* const t_on = s_t_on + lane;
  float* const appc = s_appc + lane;                      // [max_apps]
  const int base = blockIdx.x * kLanes;                   // first particle
  const int i = base + lane;
  const int n = blockIdx.y;
  const int ntiles = a.max_p_pad / kT;
  const size_t plane = static_cast<size_t>(a.max_p_pad) * a.P_pad;
  const float* g_planes = a.planes + static_cast<size_t>(n) * F * plane + base;
  const int* g_meta = a.meta + static_cast<size_t>(n) * a.max_p_pad * MS;
  float* g_far = a.far_end + static_cast<size_t>(n) * plane + base;

  for (int s = 0; s < a.S; ++s) {
    lease[s * kLanes] = 0.0f;
    t_on[s * kLanes] = INFINITY;
  }
  for (int app = 0; app < a.max_apps; ++app) appc[app * kLanes] = 0.0f;
  if (!FAITHFUL)
    for (int r = 0; r < kW; ++r) ring[r * kLanes] = 0.0f;

  // tile k of the planes: F x kT rows of 128 bytes
  auto load_planes = [&](int k) {
    float* dst = s_planes + (k % kPlaneStages) * F * kT * kLanes;
    for (int c = lane; c < F * kT * 8; c += kLanes) {
      const int f = c / (kT * 8), tl = (c / 8) % kT, q = c % 8;
      cp_async16(dst + (f * kT + tl) * kLanes + 4 * q,
                 g_planes + f * plane +
                     static_cast<size_t>(k * kT + tl) * a.P_pad + 4 * q);
    }
  };
  // tile k of the step tables: kT x MS ints
  auto load_meta = [&](int k) {
    int* dst = s_meta + (k % kMetaStages) * kT * MS;
    const int* src = g_meta + static_cast<size_t>(k) * kT * MS;
    for (int c = lane; c < kT * MS / 4; c += kLanes)
      cp_async16(dst + 4 * c, src + 4 * c);
  };
  // tile k's parents beyond the ring, this lane's particle
  auto load_far = [&](int k) {
    const int* mt = s_meta + (k % kMetaStages) * kT * MS;
    if (!(mt[0] & 4)) return;                 // the tile reads nothing far
    float* dst = s_far + (k % kPlaneStages) * kT * max_in * kLanes + lane;
    for (int tl = 0; tl < kT; ++tl)
      for (int kk = 0; kk < max_in; ++kk) {
        const int d = mt[tl * MS + 1 + kk];
        if (d > kW)
          cp_async4(dst + (tl * max_in + kk) * kLanes,
                    g_far + static_cast<size_t>(k * kT + tl - d) * a.P_pad + lane);
      }
  };

  // tiles below kAhead read nothing beyond the ring (d <= t < kAhead kT <= kW)
  for (int k = 0; k < min(2 * kAhead, ntiles); ++k) load_meta(k);
  for (int k = 0; k < min(kAhead, ntiles); ++k) load_planes(k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  float trans = 0.0f;
  float prev_end = 0.0f;                      // end of the last real step
  // the current app's completion lives in a register until the app changes
  int cur_app = 0;
  float app_max = 0.0f;
  // corrected mode with S <= 64: t_on is written once, at a server's first
  // use, tracked by a bit per server
  constexpr bool mask_on = TMASK;
  unsigned long long used = 0;
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<kAhead - 1>();              // tile k's group is in
    __syncwarp();                             // ... for every lane; k - 1 done
    if (k + kAhead < ntiles) {
      load_planes(k + kAhead);
      if (!FAITHFUL) load_far(k + kAhead);
    }
    if (k + 2 * kAhead < ntiles) load_meta(k + 2 * kAhead);
    cp_async_commit();                        // one group per tile, maybe empty

    const float* pl = s_planes + (k % kPlaneStages) * F * kT * kLanes + lane;
    const int* mt = s_meta + (k % kMetaStages) * kT * MS;
    const float* fr = s_far + (k % kPlaneStages) * kT * max_in * kLanes + lane;
    // A tile whose steps are all real walks without a check per step; only
    // a tile that reads beyond the ring looks at its far reads.
    const int tile_head = mt[0];
    const bool far_tile = !FAITHFUL && (tile_head & 4);
    auto run_tile = [&](auto all_live) {
      constexpr bool kAllLive = decltype(all_live)::value;
      for (int b0 = 0; b0 < kT; b0 += kB) {
        // the batch's carry-free values, loaded before any of its stores
        int head[kB], srv[kB], dist[kB][MAXIN];
        float exe[kB], out_t[kB], tstep[kB], mx[kB], tt[kB][MAXIN];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int tl = b0 + u;
          head[u] = mt[tl * MS];
          srv[u] = __float_as_int(pl[tl * kLanes]);
          exe[u] = pl[(kT + tl) * kLanes];
          out_t[u] = pl[(2 * kT + tl) * kLanes];
          tstep[u] = pl[(3 * kT + tl) * kLanes];
          if (FAITHFUL) {
            mx[u] = pl[(4 * kT + tl) * kLanes];
          } else {
#pragma unroll
            for (int kk = 0; kk < MAXIN; ++kk) {
              dist[u][kk] = kk < max_in ? mt[tl * MS + 1 + kk] : 0;
              tt[u][kk] = kk < max_in ? pl[((4 + kk) * kT + tl) * kLanes] : 0.0f;
            }
          }
        }
        // The next step's lease (forwarded when this step writes the same
        // server) and its parents' ends two or more steps back are read
        // before this step's stores; a parent one step back is prev_end.
        // A ring slot is read whatever the distance (the address is always
        // in range) and selected afterwards, so no step branches on it.
        float cur_lease = 0.0f, cur_on = 0.0f, cur_e[MAXIN];
        auto prepare = [&](int u, float& l, float& on, float (&e)[MAXIN]) {
          const int t = k * kT + b0 + u;
          l = lease[srv[u] * kLanes];
          if (!mask_on) on = t_on[srv[u] * kLanes];
          if (!FAITHFUL) {
#pragma unroll
            for (int kk = 0; kk < MAXIN; ++kk) {
              const int d = dist[u][kk];
              e[kk] = ring[((t - d) & (kW - 1)) * kLanes];
              if (far_tile && d > kW) e[kk] = fr[((b0 + u) * max_in + kk) * kLanes];
            }
          }
        };
        if (kAllLive || (head[0] & 1)) prepare(0, cur_lease, cur_on, cur_e);
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const bool live = kAllLive || (head[u] & 1);  // else padded: a no-op
          const int t = k * kT + b0 + u;
          float start = 0.0f, new_lease = 0.0f, t_end = 0.0f;
          if (live) {
            const int app = head[u] >> 8;     // the same for every lane
            if (app != cur_app) {
              appc[cur_app * kLanes] = app_max;
              app_max = appc[app * kLanes];
              cur_app = app;
            }
            if (FAITHFUL) {
              start = cur_lease + mx[u];
              t_end = start + exe[u];
              new_lease = (cur_lease + exe[u]) + out_t[u];
            } else {
              float gate = 0.0f;
#pragma unroll
              for (int kk = 0; kk < MAXIN; ++kk) {
                const int d = dist[u][kk];      // 0: no parent in this slot
                const float e = fmaxf(gate, (d == 1 ? prev_end : cur_e[kk]) +
                                                tt[u][kk]);
                gate = d != 0 ? e : gate;
              }
              start = fmaxf(cur_lease, gate);
              t_end = start + exe[u];
              new_lease = t_end + out_t[u];
            }
            app_max = fmaxf(app_max, t_end);
          }
          float nxt_lease = 0.0f, nxt_on = 0.0f, nxt_e[MAXIN];
          if (u + 1 < kB && (kAllLive || (head[u + 1] & 1))) {
            prepare(u + 1, nxt_lease, nxt_on, nxt_e);
            if (live && srv[u + 1] == srv[u]) {
              nxt_lease = new_lease;
              nxt_on = fminf(cur_on, start);
            }
          }
          if (live) {
            lease[srv[u] * kLanes] = new_lease;
            if (mask_on) {
              // corrected mode: a server's starts never decrease, so its
              // first start is its t_on
              const unsigned long long bit = 1ull << srv[u];
              if (!(used & bit)) t_on[srv[u] * kLanes] = start;
              used |= bit;
            } else {
              t_on[srv[u] * kLanes] = fminf(cur_on, start);
            }
            if (!FAITHFUL) {
              ring[(t & (kW - 1)) * kLanes] = t_end;
              if (head[u] & 2) g_far[static_cast<size_t>(t) * a.P_pad + lane] = t_end;
              prev_end = t_end;
            }
            trans = trans + tstep[u];
          }
          cur_lease = nxt_lease;
          cur_on = nxt_on;
#pragma unroll
          for (int kk = 0; kk < MAXIN; ++kk) cur_e[kk] = nxt_e[kk];
        }
      }
    };
    if (tile_head & 8)
      run_tile(std::true_type{});
    else
      run_tile(std::false_type{});
  }
  appc[cur_app * kLanes] = app_max;
  if (i >= a.P) return;

  unsigned flag = 0;
  for (int c = 0; c < a.n_chunks; ++c)
    flag |= a.flags[(static_cast<size_t>(n) * a.n_chunks + c) * a.P_pad + i];
  const float* cost = a.cost_per_sec + static_cast<size_t>(n) * a.S;
  float comp_cost = 0.0f;
  for (int s = 0; s < a.S; ++s) {
    const float on = t_on[s * kLanes];
    if (on != INFINITY)
      comp_cost = comp_cost + cost[s] * (lease[s * kLanes] - on);
  }
  const float* dl = a.deadline + static_cast<size_t>(n) * a.max_apps;
  bool deadline_ok = true;
  float completion = 0.0f;
  for (int app = 0; app < a.max_apps; ++app) {
    const float c = appc[app * kLanes];
    deadline_ok &= c <= dl[app];
    completion = completion + c;
  }
  const size_t out = static_cast<size_t>(n) * a.P + i;
  a.total[out] = comp_cost + trans;
  a.feasible[out] = deadline_ok && flag == 0;
  a.tsum[out] = completion;
}

template <bool FAITHFUL, int MAXIN, bool TMASK>
cudaError_t launch_walk(const Args& a, int N, cudaStream_t st) {
  const size_t smem = sizeof(float) * walk_smem_floats(a.F, a.max_in, a.S,
                                                       a.max_apps, FAITHFUL);
  cudaError_t err = cudaFuncSetAttribute(
      schedule_walk_kernel<FAITHFUL, MAXIN, TMASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  schedule_walk_kernel<FAITHFUL, MAXIN, TMASK>
      <<<dim3(a.P_pad / kLanes, N), kLanes, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool FAITHFUL, int MAXIN>
cudaError_t launch_walk(const Args& a, int N, cudaStream_t st) {
  if (!FAITHFUL && a.S <= 64) return launch_walk<FAITHFUL, MAXIN, true>(a, N, st);
  return launch_walk<FAITHFUL, MAXIN, false>(a, N, st);
}

template <bool FAITHFUL>
cudaError_t launch(const Args& a, int N, cudaStream_t st) {
  if (a.n_chunks > 0) {
    schedule_step_kernel<FAITHFUL><<<pass_grid(a, N), kStepWarps * 32, 0,
                                     st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.max_in <= 1) return launch_walk<FAITHFUL, 1>(a, N, st);
  if (a.max_in <= 2) return launch_walk<FAITHFUL, 2>(a, N, st);
  if (a.max_in <= 4) return launch_walk<FAITHFUL, 4>(a, N, st);
  return launch_walk<FAITHFUL, kMaxIn>(a, N, st);
}

}  // namespace

extern "C" {

// The walk's geometry, for the wrapper's buffers and step tables.
int schedule_replay_tile() { return kT; }
int schedule_replay_ring() { return kW; }
int schedule_replay_ahead() { return kAhead; }
int schedule_replay_chunk() { return kChunk; }

// Planes per step: srv, exe, out_t, tstep, then max_trans (faithful) or one
// transfer time per parent slot (corrected).
int schedule_replay_fields(int max_in, int faithful) {
  return pass_fields(max_in, faithful != 0);
}

size_t schedule_replay_smem_bytes(int S, int max_apps, int max_in,
                                  int faithful) {
  return sizeof(float) *
         walk_smem_floats(schedule_replay_fields(max_in, faithful), max_in, S,
                          max_apps, faithful != 0);
}

const char* schedule_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches both passes on `stream` and returns the first CUDA error (0 if
// none). Every pointer is device memory laid out as documented in
// kernels/schedule_sim.py; max_p_pad is a multiple of the tile, P_pad of 32.
int schedule_replay_launch(const int* X, const int* order, const float* compute,
                           const int* parent_idx, const float* parent_mb,
                           const int* child_idx, const float* child_mb,
                           const float* deadline, const int* pinned,
                           const float* power, const float* cost_per_sec,
                           const float* inv_bw, const float* tran_cost,
                           const uint8_t* link_ok, const int* meta,
                           float* planes, uint8_t* flags, float* far_end,
                           float* total, uint8_t* feasible, float* tsum, int N,
                           int P, int P_pad, int max_p, int max_p_pad,
                           int max_in, int max_out, int S, int max_apps,
                           int faithful, void* stream) {
  if (N < 1 || N > 65535 || P < 1 || P_pad % kLanes || P_pad < P ||
      max_p_pad % kT || max_p_pad < max_p || S < 1 || max_apps < 1 ||
      max_in < 0 || max_in > kMaxIn || max_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.X = X; a.order = order; a.compute = compute;
  a.parent_idx = parent_idx; a.parent_mb = parent_mb;
  a.child_idx = child_idx; a.child_mb = child_mb;
  a.deadline = deadline; a.pinned = pinned; a.power = power;
  a.cost_per_sec = cost_per_sec; a.inv_bw = inv_bw; a.tran_cost = tran_cost;
  a.link_ok = link_ok; a.meta = meta; a.planes = planes; a.flags = flags;
  a.far_end = far_end; a.total = total; a.feasible = feasible; a.tsum = tsum;
  a.P = P; a.P_pad = P_pad; a.max_p = max_p; a.max_p_pad = max_p_pad;
  a.rows = max_p_pad; a.max_in = max_in; a.max_out = max_out; a.S = S;
  a.max_apps = max_apps;
  a.F = schedule_replay_fields(max_in, faithful);
  a.n_chunks = (max_p + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = faithful ? launch<true>(a, N, st)
                                   : launch<false>(a, N, st);
  return static_cast<int>(err);
}

}  // extern "C"
