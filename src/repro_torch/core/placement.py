"""The bridge: any assigned architecture -> the paper's offloading
problem, ported from ``repro.core.placement`` (no traffic, warm start or
mesh yet).

A model config is *lowered* to a layer DAG whose node weights are FLOPs
(the TPU-fleet environment's server power is effective FLOP/s, so Eq. 4's
``a/p`` is seconds) and whose edge datasets are activation bytes in MB.
PSO-GA then emits a min-$ placement of model layers across a
heterogeneous fleet (cloud pods / edge slices / device nodes) under a
latency SLO (DESIGN.md §3).

Granularity: one node per transformer/mamba block, plus embed (pinned to
the request's origin device) and the LM head. Enc-dec lowers to a
*branching* DAG: the encoder output fans out to every decoder block.

``plan_offload`` = lower + deadline(HEFT × ratio) + optimize + partition.
``plan_offload_batch`` plans MANY requests in one batched PSO-GA fleet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from .baselines import greedy_offload, heft_makespan
from .batch import run_pso_ga_batch
from .dag import LayerDAG
from .device import backend_name, resolve_device
from .environment import DEVICE, Environment, tpu_fleet_environment
from .partition import Stage, contiguous_stages
from .pso_ga import PSOGAConfig, PSOGAResult, run_pso_ga

__all__ = ["arch_to_dag", "block_flops", "OffloadPlan", "plan_offload",
           "plan_offload_batch"]


def _glu_mult(act: str) -> int:
    return 3 if act in ("swiglu", "geglu") else 2


def block_flops(cfg: ModelConfig, seq: int, kind: str = "block",
                causal: bool = True) -> float:
    """Forward FLOPs of one block for a single request of ``seq`` tokens."""
    d, hd = cfg.d_model, cfg.head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    if kind == "mamba":
        din, n = cfg.d_inner, cfg.ssm_state
        proj = 2 * seq * d * (2 * din + 2 * n + cfg.ssm_heads)
        ssd = 2 * seq * din * (2 * n) + 2 * seq * cfg.ssm_chunk * din
        out = 2 * seq * din * d
        return float(proj + ssd + out)
    if kind == "head":
        return float(2 * seq * d * cfg.vocab)
    if kind == "embed":
        return float(seq * d)                      # lookup + scale, no matmul
    # attention + ffn block
    qkvo = 2 * seq * d * (h + 2 * k) * hd + 2 * seq * h * hd * d
    kv_len = seq if cfg.window == 0 else min(seq, cfg.window)
    score = 2 * 2 * seq * kv_len * h * hd * (0.5 if causal else 1.0)
    if cfg.n_experts:
        ffn = 2 * seq * _glu_mult(cfg.act) * d * cfg.d_ff * cfg.top_k \
            + 2 * seq * d * cfg.n_experts
        if cfg.moe_dense_residual:
            ffn += 2 * seq * _glu_mult(cfg.act) * d * cfg.d_ff_dense
    else:
        ffn = 2 * seq * _glu_mult(cfg.act) * d * cfg.d_ff
    if kind == "xattn_block":                      # decoder block w/ cross
        qkvo *= 2
        score *= 2
    return float(qkvo + score + ffn)


def arch_to_dag(cfg: ModelConfig, shape: ShapeSpec,
                pin_server: int = 0, deadline: float = np.inf,
                dtype_bytes: int = 2, app_id: int = 0) -> LayerDAG:
    """Lower one request (batch=1, seq=shape.seq_len) to a layer DAG."""
    s = shape.seq_len
    act_mb = s * cfg.d_model * dtype_bytes / 1e6   # boundary activation

    compute: List[float] = []
    edges: List[Tuple[int, int]] = []
    mbs: List[float] = []
    names: List[str] = []

    def node(name: str, fl: float) -> int:
        names.append(name)
        compute.append(fl)
        return len(compute) - 1

    def edge(u: int, v: int, mb: float) -> None:
        edges.append((u, v))
        mbs.append(mb)

    if cfg.family == "encdec":
        inp = node("frames", block_flops(cfg, s, "embed"))
        prev = inp
        in_mb = s * cfg.d_model * dtype_bytes / 1e6
        for i in range(cfg.enc_layers):
            n = node(f"enc{i}", block_flops(cfg, s, "block", causal=False))
            edge(prev, n, in_mb)
            prev = n
        enc_out = prev
        dec_len = max(s // 8, 1)
        dec_mb = dec_len * cfg.d_model * dtype_bytes / 1e6
        prev = node("dec_embed", block_flops(cfg, dec_len, "embed"))
        edge(inp, prev, dec_len * 4 / 1e6)         # token ids
        for i in range(cfg.dec_layers):
            n = node(f"dec{i}", block_flops(cfg, dec_len, "xattn_block"))
            edge(prev, n, dec_mb)
            edge(enc_out, n, in_mb)                # cross-attention fan-out
            prev = n
        head = node("head", block_flops(cfg, dec_len, "head"))
        edge(prev, head, dec_mb)
    elif cfg.family == "hybrid":
        inp = node("embed", block_flops(cfg, s, "embed"))
        prev = inp
        every = cfg.hybrid_attn_every
        for i in range(cfg.n_layers):
            n = node(f"mamba{i}", block_flops(cfg, s, "mamba"))
            edge(prev, n, act_mb)
            prev = n
            if every and (i + 1) % every == 0:
                a = node(f"attn{i}", block_flops(cfg, s, "block"))
                edge(prev, a, act_mb)
                prev = a
        head = node("head", block_flops(cfg, s, "head"))
        edge(prev, head, act_mb)
    elif cfg.family == "ssm":
        inp = node("embed", block_flops(cfg, s, "embed"))
        prev = inp
        for i in range(cfg.n_layers):
            n = node(f"mamba{i}", block_flops(cfg, s, "mamba"))
            edge(prev, n, act_mb)
            prev = n
        head = node("head", block_flops(cfg, s, "head"))
        edge(prev, head, act_mb)
    else:                                          # dense / moe / vlm
        inp = node("embed", block_flops(cfg, s, "embed"))
        prev = inp
        if cfg.family == "vlm":
            vis = node("vision_stub", 2.0 * cfg.vision_tokens
                       * cfg.d_model * cfg.d_model)
            edge(inp, vis, cfg.vision_tokens * cfg.d_model
                 * dtype_bytes / 1e6)
            prev = vis
        for i in range(cfg.n_layers):
            n = node(f"block{i}", block_flops(cfg, s, "block"))
            edge(prev, n, act_mb)
            prev = n
        head = node("head", block_flops(cfg, s, "head"))
        edge(prev, head, act_mb)

    p = len(compute)
    pinned = np.full(p, -1, np.int32)
    pinned[0] = pin_server
    return LayerDAG(compute=np.asarray(compute),
                    edges=np.asarray(edges, np.int32).reshape(-1, 2),
                    edge_mb=np.asarray(mbs),
                    app_id=np.full(p, app_id, np.int32),
                    deadline=np.asarray([deadline]),
                    pinned=pinned, names=names)


@dataclasses.dataclass
class OffloadPlan:
    dag: LayerDAG
    env: Environment
    result: PSOGAResult
    stages: List[Stage]
    deadline: float
    heft: float
    #: what the solver actually ran: "cuda" (the replay kernel) or "cpu"
    #: (its plain PyTorch version)
    backend: str = "cuda"

    @property
    def cost(self) -> float:
        return self.result.best_cost

    def summary(self) -> str:
        tiers = {0: "cloud", 1: "edge", 2: "device"}
        lines = [f"cost ${self.cost:.4f}  deadline {self.deadline:.3f}s "
                 f"(HEFT {self.heft:.3f}s)  feasible={self.result.feasible}"
                 f"  backend={self.backend}"]
        for st in self.stages:
            t = tiers[int(self.env.tier[st.server])]
            lines.append(
                f"  stage[{st.layers[0]}..{st.layers[-1]}] "
                f"({len(st.layers)} layers) -> s{st.server} ({t})")
        return "\n".join(lines)


def plan_offload(cfg: ModelConfig, shape: ShapeSpec,
                 env: Optional[Environment] = None,
                 deadline_ratio: float = 3.0,
                 pin_server: Optional[int] = None,
                 algo: str = "pso_ga",
                 pso: PSOGAConfig = PSOGAConfig(pop_size=64, max_iters=300,
                                                stall_iters=40),
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> OffloadPlan:
    """Lower + schedule one serving request of ``cfg`` at ``shape`` on
    ``device`` (``None`` = the card). ``algo``: pso_ga | greedy."""
    dev = resolve_device(device)
    env = env or tpu_fleet_environment()
    if pin_server is None:
        pin_server = int(env.servers_of_tier(DEVICE)[0])
    dag = arch_to_dag(cfg, shape, pin_server=pin_server)
    heft, _ = heft_makespan(dag, env)
    deadline = deadline_ratio * heft
    dag = dag.with_deadline(np.asarray([deadline]))
    if algo == "pso_ga":
        res = run_pso_ga(dag, env, pso, seed=seed, device=dev)
    elif algo == "greedy":
        res = greedy_offload(dag, env)
    else:
        raise ValueError(f"unknown algo {algo!r} (expected pso_ga | greedy)")
    stages = contiguous_stages(dag, res.best_x)
    return OffloadPlan(dag=dag, env=env, result=res, stages=stages,
                       deadline=float(deadline), heft=float(heft),
                       backend=backend_name(dev))


def plan_offload_batch(requests: Sequence[Tuple[ModelConfig, ShapeSpec,
                                                float]],
                       env: Optional[Environment] = None,
                       pin_server: Optional[int] = None,
                       pso: PSOGAConfig = PSOGAConfig(pop_size=64,
                                                      max_iters=300,
                                                      stall_iters=40),
                       seed: int = 0,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> List[OffloadPlan]:
    """Plan many serving requests with ONE batched PSO-GA fleet.

    ``requests``: sequence of (cfg, shape, deadline_ratio). All requests
    share the environment; each is lowered to its own DAG with its own
    HEFT-derived deadline, then ``run_pso_ga_batch`` solves the whole
    fleet on ``device`` (``None`` = the card); each problem matches a
    sequential ``run_pso_ga(..., seed=seed)`` gene for gene.
    """
    dev = resolve_device(device)
    env = env or tpu_fleet_environment()
    if pin_server is None:
        pin_server = int(env.servers_of_tier(DEVICE)[0])
    dags, hefts, deadlines = [], [], []
    for mcfg, shape, ratio in requests:
        dag = arch_to_dag(mcfg, shape, pin_server=pin_server)
        heft, _ = heft_makespan(dag, env)
        deadline = ratio * heft
        dags.append(dag.with_deadline(np.asarray([deadline])))
        hefts.append(float(heft))
        deadlines.append(float(deadline))
    results = run_pso_ga_batch([(d, env) for d in dags], cfg=pso, seed=seed,
                               device=dev)
    return [OffloadPlan(dag=d, env=env, result=r,
                        stages=contiguous_stages(d, r.best_x),
                        deadline=dl, heft=h, backend=backend_name(dev))
            for d, r, dl, h in zip(dags, results, deadlines, hefts)]
