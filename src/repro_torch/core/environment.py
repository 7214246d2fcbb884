"""Hybrid computing environment model (paper §III-A, Tables II–IV).

Servers s_i = <p_i, c_i^com, t_i>:
  * p_i      — compute power (work units / second; Eq. 4: T_exe = a / p)
  * c_com    — rental cost in $/second (paper quotes $/hour; we store $/s)
  * tier t_i — 0 = cloud, 1 = edge, 2 = end device

Bandwidth b_ij = <ℓ_ij, c_ij^tran>:
  * ℓ in MB/s, c_tran in $/MB (paper quotes $/GB; we store $/MB)
  * no device↔device links (no ad-hoc network): ℓ = 0
  * each end device reaches only its (two) adjacent edge servers over WIFI
  * transfers between a server and itself are free and instantaneous.

The paper's experimental fleet (Table IV + Table III) is reproduced by
``paper_environment()``. ``tpu_fleet_environment()`` instantiates the same
*structure* for a heterogeneous TPU fleet (cloud pod / edge slices /
single-chip device nodes) — see DESIGN.md §3.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

CLOUD, EDGE, DEVICE = 0, 1, 2
#: Bandwidth placeholder for "no link" — simulator maps it to +inf time.
NO_LINK = 0.0

__all__ = [
    "Environment", "paper_environment", "sample_environment",
    "tpu_fleet_environment", "CLOUD", "EDGE", "DEVICE",
]


@dataclasses.dataclass
class Environment:
    """A fleet of servers plus dense bandwidth/cost matrices.

    Attributes:
      power: (S,) float64 — work units per second per server.
      cost_per_sec: (S,) float64 — $/second rental while turned on.
      tier: (S,) int32 — 0 cloud / 1 edge / 2 device.
      bandwidth: (S, S) float64 MB/s; 0 means no link (infeasible).
      tran_cost: (S, S) float64 $/MB.
    """

    power: np.ndarray
    cost_per_sec: np.ndarray
    tier: np.ndarray
    bandwidth: np.ndarray
    tran_cost: np.ndarray

    def __post_init__(self) -> None:
        self.power = np.asarray(self.power, np.float64)
        self.cost_per_sec = np.asarray(self.cost_per_sec, np.float64)
        self.tier = np.asarray(self.tier, np.int32)
        self.bandwidth = np.asarray(self.bandwidth, np.float64)
        self.tran_cost = np.asarray(self.tran_cost, np.float64)
        s = self.num_servers
        assert self.bandwidth.shape == (s, s), "bandwidth must be (S,S)"
        assert self.tran_cost.shape == (s, s), "tran_cost must be (S,S)"
        # self-links: free + instantaneous (simulator relies on this)
        np.fill_diagonal(self.bandwidth, np.inf)
        np.fill_diagonal(self.tran_cost, 0.0)

    @property
    def num_servers(self) -> int:
        return int(self.power.shape[0])

    def servers_of_tier(self, t: int) -> np.ndarray:
        return np.nonzero(self.tier == t)[0]


def _tier_matrices(tier: np.ndarray,
                   bw_table: np.ndarray,
                   cost_table: np.ndarray,
                   device_edge_adjacency: Optional[np.ndarray] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Expand 3x3 tier-level tables into per-server matrices.

    device_edge_adjacency: optional (n_device, n_edge) bool mask restricting
    which edge servers each end device can reach (paper: two nearby edge
    servers per device). Devices not adjacent to an edge server get ℓ=0.
    """
    s = tier.shape[0]
    bw = bw_table[tier[:, None], tier[None, :]].astype(np.float64).copy()
    tc = cost_table[tier[:, None], tier[None, :]].astype(np.float64).copy()
    if device_edge_adjacency is not None:
        dev_idx = np.nonzero(tier == DEVICE)[0]
        edge_idx = np.nonzero(tier == EDGE)[0]
        adj = np.asarray(device_edge_adjacency, bool)
        assert adj.shape == (dev_idx.size, edge_idx.size)
        for a, d in enumerate(dev_idx):
            for b, e in enumerate(edge_idx):
                if not adj[a, b]:
                    bw[d, e] = bw[e, d] = NO_LINK
    return bw, tc


# Paper Table III — tier-level bandwidth (MB/s) and cost ($/GB -> $/MB).
_PAPER_BW = np.array([
    [5.0, 2.0, 2.0],   # cloud <-> {cloud, edge, device}
    [2.0, 10.0, 10.0],  # edge  <-> {cloud, edge, device}
    [2.0, 10.0, 0.0],   # device<-> {cloud, edge, device(no ad-hoc)}
])
_PAPER_TC = np.array([
    [0.4, 0.8, 0.8],
    [0.8, 0.16, 0.16],
    [0.8, 0.16, 0.0],
]) / 1024.0  # $/GB -> $/MB


def paper_environment(ring_adjacency: bool = True) -> Environment:
    """The 20-server fleet of paper Table IV.

    s_1..s_10  : end devices, 2 CPUs, free.
    s_11..s_15 : edge, 16 CPUs, $2.43/h.
    s_16..s_20 : cloud, {4,8,16,32,64} CPUs, {0.225,...,3.6}/h.

    Power is measured in CPU counts (the paper: "processing capacity ...
    roughly proportional to its cost"; we use the CPU count directly so
    Eq. 4's a/p has a concrete unit: a = CPU-seconds).
    """
    power = np.array([2.0] * 10 + [16.0] * 5 + [4.0, 8.0, 16.0, 32.0, 64.0])
    cost_h = np.array([0.0] * 10 + [2.43] * 5 + [0.225, 0.45, 0.9, 1.8, 3.6])
    tier = np.array([DEVICE] * 10 + [EDGE] * 5 + [CLOUD] * 5, np.int32)
    adj = None
    if ring_adjacency:
        # device i (0..9) reaches edge servers (i % 5) and ((i+1) % 5)
        adj = np.zeros((10, 5), bool)
        for i in range(10):
            adj[i, i % 5] = True
            adj[i, (i + 1) % 5] = True
    bw, tc = _tier_matrices(tier, _PAPER_BW, _PAPER_TC, adj)
    return Environment(power=power, cost_per_sec=cost_h / 3600.0,
                       tier=tier, bandwidth=bw, tran_cost=tc)


def sample_environment() -> Environment:
    """The 6-server illustrative fleet of paper Fig. 2 / Tables I–III.

    Power calibrated from Table I (execution times of l1..l3 on s0..s5):
    we fit p_k so a_j / p_k reproduces Table I as closely as possible
    with p normalized to the end device having power 1.
    """
    # Table I times for layers l1..l3 on servers s0..s5.
    times = np.array([
        [1.92, 0.98, 0.62, 0.31, 0.19, 0.09],
        [2.35, 1.20, 0.75, 0.67, 0.41, 0.32],
        [2.12, 1.00, 0.80, 0.56, 0.45, 0.21],
    ])
    # Least-squares fit in log space: log t_jk = log a_j - log p_k.
    logt = np.log(times)
    la = logt.mean(axis=1)
    lp = (la[:, None] - logt).mean(axis=0)
    lp -= lp[0]  # normalize p_0 = 1 -> a in device-seconds
    power = np.exp(lp)
    cost_h = np.array([0.0, 10.0, 15.0, 1.0, 2.0, 3.0])
    tier = np.array([DEVICE, CLOUD, CLOUD, EDGE, EDGE, EDGE], np.int32)
    bw, tc = _tier_matrices(tier, _PAPER_BW, _PAPER_TC)
    return Environment(power=power, cost_per_sec=cost_h / 3600.0,
                       tier=tier, bandwidth=bw, tran_cost=tc)


def tpu_fleet_environment(
    cloud_slices: Sequence[int] = (256, 256),
    edge_slices: Sequence[int] = (8, 8, 8, 8),
    device_nodes: int = 8,
    chip_flops: float = 197e12,          # bf16 peak / chip (v5e)
    mfu: float = 0.4,
    cloud_cost_chip_h: float = 1.20,     # on-demand $/chip-hour
    edge_cost_chip_h: float = 2.40,      # edge capacity is scarcer
) -> Environment:
    """The paper's environment structure instantiated for a TPU fleet.

    Power is *effective* TFLOP/s (peak × MFU) so a layer's compute amount
    is its FLOP count. Bandwidths: DCN between cloud slices 25 GB/s, WAN
    cloud↔edge 1 GB/s, edge↔edge 10 GB/s metro, edge↔device 100 MB/s
    (5G/WIFI), cloud↔device 50 MB/s. $/MB transfer costs follow typical
    egress pricing (cloud egress dominates).
    """
    n_c, n_e, n_d = len(cloud_slices), len(edge_slices), device_nodes
    power = np.array(
        [c * chip_flops * mfu for c in cloud_slices]
        + [e * chip_flops * mfu for e in edge_slices]
        # device tier = Jetson-class edge SoC, ~2% of a v5e chip effective
        + [1 * chip_flops * mfu * 0.02] * n_d)
    cost_h = np.array(
        [c * cloud_cost_chip_h for c in cloud_slices]
        + [e * edge_cost_chip_h for e in edge_slices]
        + [0.0] * n_d)
    tier = np.array([CLOUD] * n_c + [EDGE] * n_e + [DEVICE] * n_d, np.int32)
    bw_table = np.array([
        [25e3, 1e3, 50.0],
        [1e3, 10e3, 100.0],
        [50.0, 100.0, 0.0],
    ])  # MB/s
    tc_table = np.array([
        [0.01, 0.09, 0.09],
        [0.09, 0.02, 0.0],
        [0.09, 0.0, 0.0],
    ]) / 1024.0  # $/GB -> $/MB (egress-style pricing)
    adj = np.zeros((n_d, n_e), bool)
    for i in range(n_d):
        adj[i, i % n_e] = True
        adj[i, (i + 1) % n_e] = True
    bw, tc = _tier_matrices(tier, bw_table, tc_table, adj)
    return Environment(power=power, cost_per_sec=cost_h / 3600.0,
                       tier=tier, bandwidth=bw, tran_cost=tc)
