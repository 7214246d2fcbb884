"""The port's traffic replay (``kernels/traffic_sim.py`` plain version,
``core.traffic.merged_order`` and ``simulate_traffic_swarm``) against the
reference: the Pallas kernel in interpret mode, its oracle
``ref.traffic_replay_ref``, both walks of the reference's
``simulate_traffic_swarm``, and a discrete-event oracle, request for
request. Tolerances: integers and booleans exact (``static_ok``, the miss
rate, which is a ratio of small counts), float32 costs and times rtol
1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_simulator import random_dag, random_env
from test_torch_parity import CPU, RTOL, np_of, to_port

import repro.core as ref
import repro_torch.core as port
from repro.core.traffic import _merged_order
from repro.kernels.ref import traffic_replay_ref
from repro.kernels.traffic_sim import traffic_replay_folded
from repro_torch.core.simulator import kernel_args
from repro_torch.kernels import schedule_sim, traffic_sim

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# discrete-event oracle: a copy of the reference test suite's independent
# implementation of the queueing discipline (per-server FCFS in request
# arrival order, same-app ties by slot, cross-app ties by topo position)
# ---------------------------------------------------------------------------

def traffic_np(prob, x: np.ndarray, arr: np.ndarray, faithful: bool) -> dict:
    x = np.asarray(x, np.int64)
    s = prob.num_servers
    n_apps, R = arr.shape
    steps = []
    for r in range(R):
        for t, j in enumerate(prob.order):
            a = arr[prob.app_id[j], r]
            if np.isfinite(a):
                steps.append((float(a), r, t, int(j)))
    steps.sort(key=lambda z: (z[0], z[1], z[2]))

    lease = np.zeros(s)
    t_on = np.full(s, np.inf)
    end: dict = {}
    trans = 0.0
    for a, r, t, j in steps:
        srv = x[j]
        exe = prob.compute[j] / prob.power[srv]
        max_tr, gate = 0.0, a
        pars = prob.parent_idx[j]
        for k in np.nonzero(pars >= 0)[0]:
            pj = int(pars[k])
            mb = prob.parent_mb[j, k]
            tt = mb * prob.inv_bw[x[pj], srv]
            max_tr = max(max_tr, tt)
            gate = max(gate, end[(r, pj)] + tt)
            trans += prob.tran_cost[x[pj], srv] * mb
        out = 0.0
        cidx = prob.child_idx[j]
        for k in np.nonzero(cidx >= 0)[0]:
            out += prob.child_mb[j, k] * prob.inv_bw[srv, x[cidx[k]]]
        if faithful:
            base = max(lease[srv], a)
            start = base + max_tr
            lease[srv] = base + exe + out
        else:
            start = max(lease[srv], gate)
            lease[srv] = start + exe + out
        end[(r, j)] = start + exe
        t_on[srv] = min(t_on[srv], start)

    used = ~np.isinf(t_on)
    comp = float(np.sum(np.where(used, prob.cost_per_sec
                                 * (lease - np.where(used, t_on, 0.0)),
                                 0.0)))
    latency = np.zeros((n_apps, R))
    miss = np.zeros((n_apps, R), bool)
    for i in range(n_apps):
        for r in range(R):
            if not np.isfinite(arr[i, r]):
                continue
            ends = [end[(r, j)] for j in range(prob.num_layers)
                    if prob.app_id[j] == i and (r, j) in end]
            c = max(ends) if ends else 0.0
            latency[i, r] = c - arr[i, r]
            miss[i, r] = latency[i, r] > prob.deadline[i]
    n_req = max(int(np.isfinite(arr).sum()), 1)
    return {"latency": latency, "miss_rate": float(miss.sum()) / n_req,
            "total_cost": comp + trans}


def _tfields(pp):
    """The reference kernel's 15 problem arguments."""
    return (pp.order, pp.compute, pp.parent_idx, pp.parent_mb, pp.child_idx,
            pp.child_mb, pp.app_id, pp.deadline, pp.pinned, pp.power,
            pp.cost_per_sec, pp.inv_bw, pp.tran_cost, pp.link_ok, pp.num_apps)


#: one padded shape for every seeded problem (layers, servers, apps,
#: request slots), so the reference compiles each program once; the real
#: sizes inside it vary by seed, and so does every axis's padding
PAD = dict(max_p=24, max_S=9, max_apps=5)
R_PAD = 6


def _problem_and_arrivals(seed):
    """Per-app random DAGs merged into one problem on a random fleet,
    padded on every axis (layers, servers, apps, request slots), and one
    draw of one of the four arrival families; app rows past the true apps
    and request slots past the draw's cap are +inf."""
    rng = np.random.default_rng(seed)
    s = int(rng.integers(2, 7))
    n_apps = int(rng.integers(1, 4))
    dag = ref.merge_dags([random_dag(rng, int(rng.integers(2, 8)))
                          for _ in range(n_apps)])
    prob = ref.SimProblem.build(dag, random_env(rng, s))
    p = prob.num_layers
    pp = ref.pad_problem(prob, **PAD)
    R = int(rng.integers(1, R_PAD + 1))
    t = ref.sample_arrivals(ref.TRAFFIC_KINDS[seed % 4], n_apps, rate=0.5,
                            horizon=15.0, max_requests=R, n_seeds=1,
                            seed=seed).t[0]
    if not np.isfinite(t).any():
        t[0, 0] = 0.0                       # keep the replay non-trivial
    arr = np.full((PAD["max_apps"], R_PAD), np.inf)
    arr[:n_apps, :R] = t
    X = np.zeros((5, PAD["max_p"]), np.int32)
    X[:, :p] = rng.integers(0, s, size=(5, p))
    return prob, pp, arr, X


def _port_sim(pp_ref, X, arr, faithful):
    return port.simulate_traffic_swarm(to_port(pp_ref), torch.tensor(X), arr,
                                       faithful)


def _assert_sim_equal(sim, total, miss, lat_sum, static_ok, latency, tag):
    np.testing.assert_array_equal(np_of(sim.static_ok), np.asarray(static_ok),
                                  err_msg=tag)
    np.testing.assert_array_equal(np_of(sim.miss_rate), np.asarray(miss),
                                  err_msg=tag)
    for got, want in ((sim.total_cost, total), (sim.lat_sum, lat_sum),
                      (sim.latency, latency)):
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-6, err_msg=tag)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_reference_kernel_oracle_and_scans(seed, faithful):
    """Padding sweeps over all four arrival families: the port's replay
    equals the interpret-mode Pallas kernel, ``traffic_replay_ref`` and
    both walks of the reference's ``simulate_traffic_swarm``."""
    prob, pp, arr, X = _problem_and_arrivals(seed)
    sim = _port_sim(pp, X, arr, faithful)
    ker = traffic_replay_folded(*_tfields(pp), X, arr, faithful=faithful,
                                tile_p=4, interpret=True)
    _assert_sim_equal(sim, *ker, "kernel")
    _assert_sim_equal(sim, *traffic_replay_ref(*_tfields(pp), X, arr,
                                               faithful=faithful), "ref")
    for compact in (False, True):
        s = ref.simulate_traffic_swarm(pp, X, jnp.asarray(arr), faithful,
                                       compact=compact)
        _assert_sim_equal(sim, s.total_cost, s.miss_rate, s.lat_sum,
                          s.static_ok, s.latency, f"scan compact={compact}")
        np.testing.assert_array_equal(np_of(sim.miss), np.asarray(s.miss))
        np.testing.assert_array_equal(np_of(sim.req_valid),
                                      np.asarray(s.req_valid))


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("seed", [1, 4])
def test_plain_matches_des_oracle_request_for_request(seed, faithful):
    prob, pp, arr, X = _problem_and_arrivals(seed)
    sim = _port_sim(pp, X, arr, faithful)
    n_apps = prob.num_apps
    for i in range(X.shape[0]):
        des = traffic_np(prob, X[i, :prob.num_layers], arr[:n_apps],
                         faithful)
        np.testing.assert_allclose(float(sim.total_cost[i]),
                                   des["total_cost"], rtol=RTOL, atol=1e-7)
        assert float(sim.miss_rate[i]) == pytest.approx(des["miss_rate"],
                                                        abs=1e-7)
        np.testing.assert_allclose(np_of(sim.latency[i, :n_apps]),
                                   des["latency"], rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("faithful", [True, False])
def test_all_inf_app_and_padded_fleet_bucket(faithful):
    """Two problems stacked in one bucket with M = 2 draws: an app whose
    every request is +inf adds no step, latency or miss, and each lane of
    the fleet equals the unpadded replay of its own problem and draw bit
    for bit (padding adds exact zeros)."""
    rng = np.random.default_rng(17)
    probs, arrs = [], []
    for k in range(2):
        dag = ref.merge_dags([random_dag(rng, 5), random_dag(rng, 4 + k)])
        probs.append(port.SimProblem(**vars(ref.SimProblem.build(
            dag, random_env(rng, 3 + k)))))
        a = np.sort(rng.uniform(0.0, 8.0, size=(2, 2, 3)), axis=-1)
        a[0, 1] = np.inf
        arrs.append(a)
    packed = port.pack_problems(probs, device=CPU)
    arr = port.pack_arrivals(arrs, int(packed.deadline.shape[-1]))
    X = np.zeros((2, 4, packed.max_layers), np.int32)
    for n, pr in enumerate(probs):
        X[n, :, :pr.num_layers] = rng.integers(0, pr.num_servers,
                                               size=(4, pr.num_layers))
    fleet = port.simulate_traffic_swarm(packed, torch.tensor(X), arr,
                                        faithful)
    assert (np_of(fleet.latency)[0, 0, :, 1] == 0).all()
    assert (np_of(fleet.latency)[0, 1, :, 1] > 0).all()
    for n, pr in enumerate(probs):
        own = port.simulate_traffic_swarm(
            port.pad_problem(pr, device=CPU),
            torch.tensor(X[n, :, :pr.num_layers]), arrs[n], faithful)
        assert torch.equal(fleet.static_ok[n], own.static_ok)
        for f in ("total_cost", "miss_rate", "lat_sum"):
            assert torch.equal(getattr(fleet, f)[n], getattr(own, f)), f
        assert torch.equal(fleet.latency[n, :, :, :pr.num_apps],
                           own.latency)


@pytest.mark.parametrize("faithful", [True, False])
def test_zero_contention_equals_schedule_replay_bit_for_bit(faithful):
    """R = 1 request per app at t = 0 is the single-shot replay: total
    cost and the latency sum equal ``schedule_replay_plain``'s cost and
    completion sum bit for bit."""
    rng = np.random.default_rng(11)
    dag = ref.merge_dags([random_dag(rng, 6), random_dag(rng, 6)])
    prob = ref.SimProblem.build(dag, random_env(rng, 4))
    pp = to_port(ref.pad_problem(prob, max_p=16, max_S=6, max_apps=3))
    X = torch.zeros((6, 16), dtype=torch.int32)
    X[:, :prob.num_layers] = torch.as_tensor(
        rng.integers(0, 4, size=(6, prob.num_layers)))
    arr = np.full((3, 1), np.inf)
    arr[:2] = port.zero_contention_arrivals(2)[0]
    sim = port.simulate_traffic_swarm(pp, X, arr, faithful)
    total, _, tsum = schedule_sim.schedule_replay_plain(
        *kernel_args(pp), X[None], faithful=faithful)
    assert torch.equal(sim.total_cost, total[0])
    assert torch.equal(sim.lat_sum, tsum[0])


def test_merged_order_equals_reference_with_ties():
    """Same-app ties (equal slots), cross-app ties, two float64 times that
    round to one float32 value, and +inf slots: the stable sort on the
    float32 key gives the reference lexsort's order and prefix."""
    rng = np.random.default_rng(5)
    dag = ref.merge_dags([random_dag(rng, 5), random_dag(rng, 4),
                          random_dag(rng, 3)])
    prob = ref.SimProblem.build(dag, random_env(rng, 3))
    pp = ref.pad_problem(prob, max_p=16, max_apps=4)
    arr = np.array([[1.0, 1.0, 2.5, np.inf],
                    [1.0, 2.5, 2.5, 7.0],
                    [0.5, 1.0 + 1e-9, 2.5, np.inf],
                    [np.inf] * 4])
    want = _merged_order(pp, jnp.asarray(arr))
    got = port.merged_order(to_port(pp), arr)
    for name, w in zip(("t_m", "r_m", "key_m", "valid_m", "n_valid"), want):
        np.testing.assert_array_equal(np_of(getattr(got, name)),
                                      np.asarray(w), err_msg=name)
    nv = int(got.n_valid)
    assert nv == 3 * 5 + 4 * 4 + 3 * 3       # finite requests x app layers
    jsafe = np.maximum(np.asarray(pp.order), 0)
    np.testing.assert_array_equal(
        np_of(got.slot_m), np_of(got.r_m) * 16 + jsafe[np_of(got.t_m)])
    assert (np_of(got.arr_m)[nv:] == 0).all()


def test_traffic_replay_routes_by_device():
    """A CPU problem takes the plain version and never counts a launch;
    any other device type is refused."""
    prob, pp, arr, X = _problem_and_arrivals(2)
    ppt = to_port(pp)
    tin = port.traffic_inputs(ppt, arr[None])
    before = traffic_sim.traffic_replay.launches
    out = traffic_sim.traffic_replay(*kernel_args(ppt), torch.tensor(X)[None],
                                     *tin)
    assert traffic_sim.traffic_replay.launches == before
    assert out[0].shape == (1, 1, 5) and out[4] is None
    with pytest.raises(ValueError, match="cpu or cuda"):
        traffic_sim.traffic_replay(*kernel_args(ppt),
                                   torch.tensor(X)[None].to("meta"), *tin)


def test_replay_without_arrival_draws_is_refused():
    """M = 0 draws leave no result to report beside ``static_ok``: the
    plain version refuses it, as the kernel's wrapper does."""
    _, pp, arr, X = _problem_and_arrivals(2)
    ppt = to_port(pp)
    tin = port.traffic_inputs(ppt, arr[None])
    empty = port.TrafficInputs(*(t[:, :0] for t in tin))
    for fn in (traffic_sim.traffic_replay, traffic_sim.traffic_replay_plain):
        with pytest.raises(ValueError, match="M >= 1"):
            fn(*kernel_args(ppt), torch.tensor(X)[None], *empty)


def test_traffic_inputs_reject_arrivals_of_another_shape():
    _, pp, arr, _ = _problem_and_arrivals(3)
    ppt = to_port(pp)
    with pytest.raises(ValueError, match="max_apps"):
        port.traffic_inputs(ppt, arr[None, :-1])
    with pytest.raises(ValueError, match="max_apps"):
        port.traffic_inputs(ppt, arr)


# ---------------------------------------------------------------------------
# the kernel's walk: per-draw step tables and ring addressing, on the CPU
# ---------------------------------------------------------------------------

def _ring_case(name):
    """``(kernel_args, X, TrafficInputs)`` of one stacked bucket:

    * ``seeded``: seed 1's padded problem and draw (every axis padded);
    * ``fleet``: the all-+inf-app fleet bucket of two problems, M = 2;
    * ``ties``: two apps of one problem, draw 0 ``zero_contention_arrivals``
      (every request at t = 0), draw 1 both apps' requests at the same
      times (ties across apps and within one), draw 2 no request at all
      (n_valid = 0);
    * ``skip``: a 50-layer chain with skip edges up to 49 layers back and
      two apps, under bursty draws: most parents lie beyond a short ring.
    """
    from test_torch_schedule_sim import _skip_dag
    rng = np.random.default_rng(23)
    if name == "seeded":
        _, pp, arr, X = _problem_and_arrivals(1)
        ppt = to_port(pp)
        return kernel_args(ppt), torch.tensor(X)[None], \
            port.traffic_inputs(ppt, arr[None])
    if name == "fleet":
        probs, arrs = [], []
        for k in range(2):
            dag = ref.merge_dags([random_dag(rng, 5), random_dag(rng, 4 + k)])
            probs.append(port.SimProblem(**vars(ref.SimProblem.build(
                dag, random_env(rng, 3 + k)))))
            a = np.sort(rng.uniform(0.0, 8.0, size=(2, 2, 3)), axis=-1)
            a[0, 1] = np.inf
            arrs.append(a)
        ppb = port.pack_problems(probs, device=CPU)
        arr = port.pack_arrivals(arrs, int(ppb.deadline.shape[-1]))
    else:
        if name == "ties":
            dag = ref.merge_dags([random_dag(rng, 7), random_dag(rng, 6)])
            arr = np.full((3, 2, 3), np.inf)
            arr[0, :, :1] = port.zero_contention_arrivals(2)[0]
            arr[1] = [[1.0, 1.0, 2.5], [1.0, 2.5, 2.5]]
        else:
            dag = _skip_dag()
            arr = port.sample_arrivals("bursty", 2, rate=0.5, horizon=15.0,
                                       max_requests=3, n_seeds=2,
                                       seed=3).t
        probs = [port.SimProblem(**vars(ref.SimProblem.build(
            dag, random_env(rng, 4))))]
        ppb = port.pack_problems(probs, device=CPU)
        arr = port.pack_arrivals([arr], int(ppb.deadline.shape[-1]))
    X = np.zeros((len(probs), 7, ppb.max_layers), np.int32)
    for n, pr in enumerate(probs):
        X[n, :, :pr.num_layers] = rng.integers(0, pr.num_servers,
                                               size=(7, pr.num_layers))
        pins = np.flatnonzero(pr.pinned >= 0)
        X[n, :3][:, pins] = pr.pinned[pins]
    return kernel_args(ppb), torch.tensor(X), port.traffic_inputs(ppb, arr)


def _tables_by_loop(order, pidx, app, slot_m, n_valid, R, ring, tile):
    """``traffic_step_tables`` of one lane, step by step in Python."""
    max_p = len(order)
    T = len(slot_m)
    T_pad = -(-T // tile) * tile
    pos = {int(j): t for t, j in enumerate(order) if j >= 0}
    at = {int(s): t for t, s in enumerate(slot_m[:n_valid])}
    want = np.zeros((T_pad, 2 + pidx.shape[1]), np.int64)
    read_far = set()
    for t in range(n_valid):
        r, j = divmod(int(slot_m[t]), max_p)
        want[t, 1] = pos[j]
        for k, pj in enumerate(pidx[j]):
            if pj >= 0:
                tp = at.get(r * max_p + int(pj), n_valid)
                want[t, 2 + k] = t - tp if tp < t else -1
                if want[t, 2 + k] > ring:
                    read_far.add(tp)
    for t in range(n_valid):
        r, j = divmod(int(slot_m[t]), max_p)
        want[t, 0] = 1 | 2 * (t in read_far) | ((int(app[j]) * R + r) << 8)
    for t0 in range(0, T_pad, tile):
        rows = want[t0:t0 + tile]
        want[t0, 0] |= 4 * bool((rows[:, 2:] > ring).any()) \
            | 8 * bool((rows[:, 0] & 1).all())
    return want


@pytest.mark.parametrize("ring,tile", [(2, 1), (4, 2), (traffic_sim.RING,
                                                        traffic_sim.TILE)])
@pytest.mark.parametrize("name", ["fleet", "ties", "skip"])
def test_traffic_step_tables_against_a_loop(name, ring, tile):
    """Per (problem, draw) lane: each merged step's topo position, real
    bit, completion column, "read beyond the ring" bit and each parent's
    distance in merged steps, and each tile's bits, against a direct walk
    of the lane's merged order; the step axis is padded to whole tiles."""
    args, _, tin = _ring_case(name)
    order, pidx, app = args[0], args[2], args[6]
    A, R = tin.arr2.shape[-2:]
    meta = np_of(traffic_sim.traffic_step_tables(
        order, pidx, app, tin.slot_m, tin.n_valid, R, ring=ring, tile=tile))
    N, M, T = tin.slot_m.shape
    assert meta.shape == (N, M, -(-T // tile) * tile, 2 + pidx.shape[-1])
    for n in range(N):
        for m in range(M):
            want = _tables_by_loop(
                np_of(order[n]), np_of(pidx[n]), np_of(app[n]),
                np_of(tin.slot_m[n, m]), int(tin.n_valid[n, m]), R, ring,
                tile)
            np.testing.assert_array_equal(meta[n, m], want,
                                          err_msg=f"lane {n}, {m}")
    if name == "skip":          # skip edges 49 layers long, and longer
        assert meta[..., 2:].max() >= 49   # where the apps' requests mix
        assert ((meta[..., 2:] > ring).any()) == (ring < meta[..., 2:].max())
    if name == "ties":
        assert int(tin.n_valid[0, 2]) == 0 and not (meta[0, 2, :, 0] & 1).any()


def test_traffic_step_tables_mark_parents_not_yet_run():
    """The skip DAG's edges from app 0 into app 1 join requests that
    arrive apart: a parent whose step comes later in the draw, or not at
    all, has distance -1 (its end reads 0, as the plain version's end
    buffer holds it until that step); every other parent comes first."""
    args, _, tin = _ring_case("skip")
    R = tin.arr2.shape[-1]
    meta = traffic_sim.traffic_step_tables(args[0], args[2], args[6],
                                           tin.slot_m, tin.n_valid, R)
    dist = meta[..., 2:]
    assert (dist == -1).any() and (dist >= -1).all()
    steps = torch.arange(meta.shape[2])[:, None]
    assert (dist <= steps).all()


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("ring,tile,ahead", [
    (2, 1, 1), (4, 1, 3), (8, 2, 3), (8, 4, 1),
    (traffic_sim.RING, traffic_sim.TILE, traffic_sim.AHEAD)])
@pytest.mark.parametrize("name", ["seeded", "fleet", "ties", "skip"])
def test_traffic_ring_walk_equals_plain_bit_for_bit(name, ring, tile, ahead,
                                                    faithful):
    """The walk's tables, ring and far-read addressing
    (``traffic_ring_plain``, far reads copied ``ahead`` tiles early, ends
    not yet stored read as NaN) give every output of
    ``traffic_replay_plain`` bit for bit, the latency grid included, on
    padded problems, a fleet bucket with an all-+inf app, tied arrivals
    and an empty draw, and skip edges far beyond a short ring."""
    args, X, tin = _ring_case(name)
    N, P = X.shape[:2]
    M, A, R = tin.arr2.shape[1:]
    lat_r = torch.full((N, M, P, A, R), float("nan"))
    lat_p = torch.full((N, M, P, A, R), float("nan"))
    got = traffic_sim.traffic_ring_plain(*args, X, *tin, faithful=faithful,
                                         latency=lat_r, ring=ring, tile=tile,
                                         ahead=ahead)
    want = traffic_sim.traffic_replay_plain(*args, X, *tin,
                                            faithful=faithful, latency=lat_p)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k
    assert torch.isfinite(got[0]).all() and got[3].any()
    if name == "ties":                     # the empty draw reports nothing
        assert (got[0][0, 2] == 0).all() and (got[1][0, 2] == 0).all()
        assert (lat_r[0, 2] == 0).all()


def test_traffic_ring_walk_refuses_a_ring_shorter_than_its_copies_reach():
    args, X, tin = _ring_case("ties")
    with pytest.raises(ValueError, match="must hold 4 tiles"):
        traffic_sim.traffic_ring_plain(*args, X, *tin, faithful=False,
                                       ring=8, tile=3, ahead=3)


def test_padded_layers_carry_no_pin():
    """The kernels check pins gene by gene, padded genes included, as the
    plain version's ``pin_ok``; a padded problem's padded layers are never
    pinned, so no padded gene can fail a pin."""
    args, _, _ = _ring_case("fleet")
    order, pinned = args[0], args[8]
    n_real = (order >= 0).sum(-1, keepdim=True)
    padded = torch.arange(order.shape[1]) >= n_real
    assert padded.any() and (pinned[padded] == -1).all()
