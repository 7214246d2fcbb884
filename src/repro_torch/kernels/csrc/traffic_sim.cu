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
// What bounds it: not bytes and not arithmetic, but the serial chain of
// n_valid merged steps per (problem, draw, particle): a step's start waits
// on the lease of its server and, in corrected mode, on its parents' end
// times. So every load is kept off that chain, and the quantities that do
// not depend on it, the same for each of the R request copies and M draws,
// are computed once. This design is B1's (schedule_sim.cu) adapted to the
// merged order, as the reference's Pallas kernel splits the work
// (carry-free planes by topo position, then a walk that reads row qm[t] at
// merged step t):
//
//   * Two launches per call. traffic_step_kernel is the carry-free pass that
//     B1 runs too (pass_body in replay_common.cuh): once per (problem, topo
//     position, particle), not once per request copy and draw, into
//     step-major planes[n][field][t][i], plus per-chunk link and pin flags;
//     static_ok is "no flag set", which does not depend on the arrivals.
//   * traffic_walk_kernel carries the recurrence: one warp per block, one
//     particle per lane, grid (P_pad / 32, M, N), so every (problem, draw)
//     lane walks its own n_valid steps on its own blocks. Each merged step's
//     plane rows are gathered at its topo position q through a cp.async ring
//     of kT-step tiles, kAhead tiles in flight; all 32 lanes of a block share
//     the lane's merged order, so a row is still one 128-byte copy per field.
//     The step tables (kernels/traffic_sim.py::traffic_step_tables, built
//     once per solve: q, "a real step", the completion column c = app R + r,
//     "this end is read beyond the ring", per tile "every step is real" and
//     "reads beyond the ring", and each parent's distance in merged steps)
//     come through a second ring that runs kAhead tiles further ahead, so a
//     tile's q is in shared memory before its rows are copied; the draw's
//     arrivals come with the rows.
//   * A single warp issues in order: the walk takes a batch of steps'
//     carry-free values into registers before any of their stores, and reads
//     the next step's lease and parents' ring slots before this step's
//     stores (forwarding the lease when both steps use the same server).
//   * Parents' end times: the previous step's end sits in a register; older
//     ends live in a per-lane ring of the last kW ends in shared memory; an
//     end read more than kW steps later also goes to far_end in global
//     memory, and the walk copies those reads kAhead tiles ahead, which
//     kW >= (kAhead + 1) kT makes safe. A parent that has not run yet in the
//     draw (distance -1: an edge between apps whose requests arrive apart)
//     reads 0, as the plain version's end buffer holds it until then.
//     Faithful mode reads no ends: no ring.
//   * A request's completion is a running max in a register while the
//     completion column c stays the same (a request's layers form a run of
//     the merged order unless arrivals tie), flushed to [max_apps R][32]
//     shared memory when c changes. Server state is [S][32]; in corrected
//     mode a server's starts never decrease, so t_on is stored once, at its
//     first use (S <= 64).
//
// Numbers: every float sum keeps the plain version's order (merged steps;
// parents, then children; servers, then apps x requests) and every product
// and quotient is rounded on its own (--fmad=false), so the outputs equal
// kernels/traffic_sim.py::traffic_replay_plain's bit for bit; max and min
// are order-free.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// -Xcompiler -fPIC (kernels/_build.py).

#include <type_traits>

#include "replay_common.cuh"

namespace {

struct WalkArgs {
  const int* meta;          // (N, M, T_pad, 2 + max_in) step tables
  const float* planes;      // (N, F, max_p, P_pad) from the carry-free pass
  const uint8_t* flags;     // (N, n_chunks, P_pad)
  const float* arr_m;       // (N, M, T) arrival of each merged step
  const int* n_valid;       // (N, M)
  const float* arr2;        // (N, M, max_apps * R) request arrivals
  const uint8_t* req_valid;
  const float* deadline;    // (N, max_apps)
  const float* cost_per_sec;  // (N, S)
  float* far_end;           // (N, M, T_pad, P_pad), corrected mode
  float* total;             // (N, M, P)
  float* miss_rate;
  float* lat_sum;
  uint8_t* static_ok;       // (N, P)
  float* latency;           // (N, M, P, max_apps * R), or null
  int P, P_pad, max_p, T, T_pad, max_in, S, max_apps, R, F, n_chunks;
};

// ---------------------------------------------------------------------------
// pass 1: the carry-free quantities of every (topo position, particle)
// ---------------------------------------------------------------------------
template <bool FAITHFUL>
__global__ void __launch_bounds__(kStepWarps * 32)
traffic_step_kernel(const PassArgs a) {
  pass_body<FAITHFUL>(a);
}

// ---------------------------------------------------------------------------
// pass 2: the carried walk over each (problem, draw)'s merged order
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t walk_smem_floats(int F, int max_in, int S,
                                                      int AR, bool faithful) {
  return static_cast<size_t>(kPlaneStages * F * kT * kLanes)      // planes
         + kPlaneStages * kT                                      // arrivals
         + (faithful ? 0 : kPlaneStages * kT * max_in * kLanes    // far reads
                               + kW * kLanes)                     // ring
         + static_cast<size_t>(2 * S + AR) * kLanes               // lease t_on appc
         + kMetaStages * kT * (2 + max_in);                       // step tables
}

// MAXIN: the parent slots a step's registers hold (>= max_in). TMASK
// (corrected mode, S <= 64): t_on is stored once, at a server's first use.
template <bool FAITHFUL, int MAXIN, bool TMASK>
__global__ void __launch_bounds__(kLanes)
traffic_walk_kernel(const WalkArgs a) {
  constexpr int kB = MAXIN <= 4 ? 8 : 4;
  static_assert(kT % kB == 0, "a tile holds whole batches");
  extern __shared__ __align__(16) float smem[];
  const int F = a.F, max_in = a.max_in, MS = 2 + max_in;
  const int AR = a.max_apps * a.R;
  float* s_planes = smem;                                 // [stage][F][kT][32]
  float* s_arr = s_planes + kPlaneStages * F * kT * kLanes;  // [stage][kT]
  float* s_far = s_arr + kPlaneStages * kT;               // [stage][kT][max_in][32]
  float* s_ring = s_far + (FAITHFUL ? 0 : kPlaneStages * kT * max_in * kLanes);
  float* s_lease = s_ring + (FAITHFUL ? 0 : kW * kLanes);  // [S][32]
  float* s_t_on = s_lease + a.S * kLanes;                 // [S][32]
  float* s_appc = s_t_on + a.S * kLanes;                  // [AR][32]
  int* s_meta = reinterpret_cast<int*>(s_appc + AR * kLanes);  // [stage][kT][MS]

  const int lane = threadIdx.x;
  // this lane's column of the per-particle state
  float* const ring = s_ring + lane;                      // [kW] by step
  float* const lease = s_lease + lane;                    // [S] by server
  float* const t_on = s_t_on + lane;
  float* const appc = s_appc + lane;                      // [AR] by column
  const int base = blockIdx.x * kLanes;                   // first particle
  const int i = base + lane;
  const int m = blockIdx.y, n = blockIdx.z;
  const size_t ln = static_cast<size_t>(n) * gridDim.y + m;  // (problem, draw)
  const int ntiles = (a.n_valid[ln] + kT - 1) / kT;
  const size_t plane = static_cast<size_t>(a.max_p) * a.P_pad;
  const float* g_planes = a.planes + static_cast<size_t>(n) * F * plane + base;
  const int* g_meta = a.meta + ln * a.T_pad * MS;
  const float* g_arr = a.arr_m + ln * a.T;
  float* g_far = a.far_end + ln * a.T_pad * a.P_pad + base;

  for (int s = 0; s < a.S; ++s) {
    lease[s * kLanes] = 0.0f;
    t_on[s * kLanes] = INFINITY;
  }
  for (int c = 0; c < AR; ++c) appc[c * kLanes] = 0.0f;
  if (!FAITHFUL)
    for (int r = 0; r < kW; ++r) ring[r * kLanes] = 0.0f;

  // tile k of the step tables: kT x MS ints
  auto load_meta = [&](int k) {
    int* dst = s_meta + (k % kMetaStages) * kT * MS;
    const int* src = g_meta + static_cast<size_t>(k) * kT * MS;
    for (int c = lane; c < kT * MS / 4; c += kLanes)
      cp_async16(dst + 4 * c, src + 4 * c);
  };
  // tile k of the planes, step tl's rows gathered at its topo position q,
  // and its arrivals; the tile's tables are in shared memory
  auto load_planes = [&](int k) {
    const int* mt = s_meta + (k % kMetaStages) * kT * MS;
    float* dst = s_planes + (k % kPlaneStages) * F * kT * kLanes;
    for (int c = lane; c < F * kT * 8; c += kLanes) {
      const int f = c / (kT * 8), tl = (c / 8) % kT, v = c % 8;
      cp_async16(dst + (f * kT + tl) * kLanes + 4 * v,
                 g_planes + f * plane +
                     static_cast<size_t>(mt[tl * MS + 1]) * a.P_pad + 4 * v);
    }
    if (lane < kT && k * kT + lane < a.T)
      cp_async4(s_arr + (k % kPlaneStages) * kT + lane, g_arr + k * kT + lane);
  };
  // tile k's parents beyond the ring, this lane's particle
  auto load_far = [&](int k) {
    const int* mt = s_meta + (k % kMetaStages) * kT * MS;
    if (!(mt[0] & 4)) return;                 // the tile reads nothing far
    float* dst = s_far + (k % kPlaneStages) * kT * max_in * kLanes + lane;
    for (int tl = 0; tl < kT; ++tl)
      for (int kk = 0; kk < max_in; ++kk) {
        const int d = mt[tl * MS + 2 + kk];
        if (d > kW)
          cp_async4(dst + (tl * max_in + kk) * kLanes,
                    g_far + static_cast<size_t>(k * kT + tl - d) * a.P_pad + lane);
      }
  };

  // the tables first: a tile's rows are copied from its q. Tiles below
  // kAhead read nothing beyond the ring (d <= t < kAhead kT <= kW).
  for (int k = 0; k < min(2 * kAhead, ntiles); ++k) load_meta(k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  for (int k = 0; k < min(kAhead, ntiles); ++k) load_planes(k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  float trans = 0.0f;
  float prev_end = 0.0f;                      // end of the last real step
  // the current completion column's max lives in a register until c changes
  int cur_c = 0;
  float c_max = 0.0f;
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
    const float* ar = s_arr + (k % kPlaneStages) * kT;
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
        float exe[kB], out_t[kB], tstep[kB], mx[kB], arr[kB], tt[kB][MAXIN];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int tl = b0 + u;
          head[u] = mt[tl * MS];
          arr[u] = ar[tl];
          srv[u] = __float_as_int(pl[tl * kLanes]);
          exe[u] = pl[(kT + tl) * kLanes];
          out_t[u] = pl[(2 * kT + tl) * kLanes];
          tstep[u] = pl[(3 * kT + tl) * kLanes];
          if (FAITHFUL) {
            mx[u] = pl[(4 * kT + tl) * kLanes];
          } else {
#pragma unroll
            for (int kk = 0; kk < MAXIN; ++kk) {
              dist[u][kk] = kk < max_in ? mt[tl * MS + 2 + kk] : 0;
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
              if (d < 0) e[kk] = 0.0f;        // the parent has not run yet
            }
          }
        };
        if (kAllLive || (head[0] & 1)) prepare(0, cur_lease, cur_on, cur_e);
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const bool live = kAllLive || (head[u] & 1);  // else past n_valid
          const int t = k * kT + b0 + u;
          float start = 0.0f, new_lease = 0.0f, t_end = 0.0f;
          if (live) {
            const int c = head[u] >> 8;       // the same for every lane
            if (c != cur_c) {
              appc[cur_c * kLanes] = c_max;
              c_max = appc[c * kLanes];
              cur_c = c;
            }
            if (FAITHFUL) {
              const float b = fmaxf(cur_lease, arr[u]);
              start = b + mx[u];
              t_end = start + exe[u];
              new_lease = (b + exe[u]) + out_t[u];
            } else {
              float gate = 0.0f;
#pragma unroll
              for (int kk = 0; kk < MAXIN; ++kk) {
                const int d = dist[u][kk];      // 0: no parent in this slot
                const float e = fmaxf(gate, (d == 1 ? prev_end : cur_e[kk]) +
                                                tt[u][kk]);
                gate = d != 0 ? e : gate;
              }
              start = fmaxf(cur_lease, fmaxf(gate, arr[u]));
              t_end = start + exe[u];
              new_lease = t_end + out_t[u];
            }
            c_max = fmaxf(c_max, t_end);
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
  appc[cur_c * kLanes] = c_max;
  if (i >= a.P) return;

  if (m == 0) {                               // static: once per particle
    unsigned flag = 0;
    for (int c = 0; c < a.n_chunks; ++c)
      flag |= a.flags[(static_cast<size_t>(n) * a.n_chunks + c) * a.P_pad + i];
    a.static_ok[static_cast<size_t>(n) * a.P + i] = flag == 0;
  }
  // epilogue: servers, then apps x requests, in that order
  const float* cost = a.cost_per_sec + static_cast<size_t>(n) * a.S;
  float comp_cost = 0.0f;
  for (int s = 0; s < a.S; ++s) {
    const float on = t_on[s * kLanes];
    if (on != INFINITY)
      comp_cost = comp_cost + cost[s] * (lease[s * kLanes] - on);
  }
  const float* dl = a.deadline + static_cast<size_t>(n) * a.max_apps;
  const float* a2 = a.arr2 + ln * AR;
  const uint8_t* rv = a.req_valid + ln * AR;
  const size_t out = ln * a.P + i;
  float* lat_out = a.latency == nullptr ? nullptr : a.latency + out * AR;
  float misses = 0.0f, lsum = 0.0f, n_req = 0.0f;
  for (int app = 0; app < a.max_apps; ++app) {
    for (int r = 0; r < a.R; ++r) {
      const int c = app * a.R + r;
      const bool real = rv[c] != 0;
      const float lat = real ? appc[c * kLanes] - a2[c] : 0.0f;
      if (lat_out != nullptr) lat_out[c] = lat;
      if (real && lat > dl[app]) misses = misses + 1.0f;
      lsum = lsum + lat;
      if (real) n_req = n_req + 1.0f;
    }
  }
  a.total[out] = comp_cost + trans;
  a.miss_rate[out] = misses / fmaxf(n_req, 1.0f);
  a.lat_sum[out] = lsum;
}

template <bool FAITHFUL, int MAXIN, bool TMASK>
cudaError_t launch_walk(const WalkArgs& w, int N, int M, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      walk_smem_floats(w.F, w.max_in, w.S, w.max_apps * w.R, FAITHFUL);
  cudaError_t err = cudaFuncSetAttribute(
      traffic_walk_kernel<FAITHFUL, MAXIN, TMASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  traffic_walk_kernel<FAITHFUL, MAXIN, TMASK>
      <<<dim3(w.P_pad / kLanes, M, N), kLanes, smem, st>>>(w);
  return cudaGetLastError();
}

template <bool FAITHFUL, int MAXIN>
cudaError_t launch_walk(const WalkArgs& w, int N, int M, cudaStream_t st) {
  if (!FAITHFUL && w.S <= 64)
    return launch_walk<FAITHFUL, MAXIN, true>(w, N, M, st);
  return launch_walk<FAITHFUL, MAXIN, false>(w, N, M, st);
}

template <bool FAITHFUL>
cudaError_t launch(const PassArgs& p, const WalkArgs& w, int N, int M,
                   cudaStream_t st) {
  if (p.n_chunks > 0) {
    traffic_step_kernel<FAITHFUL><<<pass_grid(p, N), kStepWarps * 32, 0,
                                    st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (w.max_in <= 1) return launch_walk<FAITHFUL, 1>(w, N, M, st);
  if (w.max_in <= 2) return launch_walk<FAITHFUL, 2>(w, N, M, st);
  if (w.max_in <= 4) return launch_walk<FAITHFUL, 4>(w, N, M, st);
  return launch_walk<FAITHFUL, kMaxIn>(w, N, M, st);
}

}  // namespace

extern "C" {

// The walk's geometry, for the wrapper's buffers and step tables.
int traffic_replay_tile() { return kT; }
int traffic_replay_ring() { return kW; }
int traffic_replay_ahead() { return kAhead; }
int traffic_replay_chunk() { return kChunk; }

int traffic_replay_fields(int max_in, int faithful) {
  return pass_fields(max_in, faithful != 0);
}

size_t traffic_replay_smem_bytes(int S, int max_apps, int R, int max_in,
                                 int faithful) {
  return sizeof(float) *
         walk_smem_floats(pass_fields(max_in, faithful != 0), max_in, S,
                          max_apps * R, faithful != 0);
}

const char* traffic_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches both passes on `stream` and returns the first CUDA error (0 if
// none). Every pointer is device memory laid out as documented in
// kernels/traffic_sim.py; `latency` may be null (the grid is then not
// written). T = R max_p; T_pad is a multiple of the tile, P_pad of 32.
int traffic_replay_launch(const int* X, const int* order, const float* compute,
                          const int* parent_idx, const float* parent_mb,
                          const int* child_idx, const float* child_mb,
                          const float* deadline, const int* pinned,
                          const float* power, const float* cost_per_sec,
                          const float* inv_bw, const float* tran_cost,
                          const uint8_t* link_ok, const int* meta,
                          const float* arr_m, const int* n_valid,
                          const float* arr2, const uint8_t* req_valid,
                          float* planes, uint8_t* flags, float* far_end,
                          float* total, float* miss_rate, float* lat_sum,
                          uint8_t* static_ok, float* latency, int N, int M,
                          int P, int P_pad, int max_p, int T_pad, int max_in,
                          int max_out, int S, int max_apps, int R,
                          int faithful, void* stream) {
  if (N < 1 || N > 65535 || M < 1 || M > 65535 || P < 1 || P_pad % kLanes ||
      P_pad < P || max_p < 1 || R < 1 || T_pad % kT || T_pad < R * max_p ||
      S < 1 || max_apps < 1 || max_apps * R >= (1 << 23) || max_in < 0 ||
      max_in > kMaxIn || max_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PassArgs p;
  p.X = X; p.order = order; p.compute = compute;
  p.parent_idx = parent_idx; p.parent_mb = parent_mb;
  p.child_idx = child_idx; p.child_mb = child_mb; p.pinned = pinned;
  p.power = power; p.inv_bw = inv_bw; p.tran_cost = tran_cost;
  p.link_ok = link_ok; p.planes = planes; p.flags = flags;
  p.P = P; p.P_pad = P_pad; p.max_p = max_p; p.rows = max_p;
  p.max_in = max_in; p.max_out = max_out; p.S = S;
  p.F = pass_fields(max_in, faithful != 0);
  p.n_chunks = (max_p + kChunk - 1) / kChunk;
  WalkArgs w;
  w.meta = meta; w.planes = planes; w.flags = flags; w.arr_m = arr_m;
  w.n_valid = n_valid; w.arr2 = arr2; w.req_valid = req_valid;
  w.deadline = deadline; w.cost_per_sec = cost_per_sec; w.far_end = far_end;
  w.total = total; w.miss_rate = miss_rate; w.lat_sum = lat_sum;
  w.static_ok = static_ok; w.latency = latency;
  w.P = P; w.P_pad = P_pad; w.max_p = max_p; w.T = R * max_p; w.T_pad = T_pad;
  w.max_in = max_in; w.S = S; w.max_apps = max_apps; w.R = R; w.F = p.F;
  w.n_chunks = p.n_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = faithful ? launch<true>(p, w, N, M, st)
                                   : launch<false>(p, w, N, M, st);
  return static_cast<int>(err);
}

}  // extern "C"
