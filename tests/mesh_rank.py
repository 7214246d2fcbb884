"""One rank of the port's CPU mesh tests, as its own process:

    python tests/mesh_rank.py TASK RANK WORLD STORE OUT [IN]

The ranks of a world meet over ``gloo`` through a ``FileStore`` at STORE
and each writes its results to ``OUT`` with ``-<rank>.npz`` appended;
``IN`` is an ``.npz`` of inputs the test made. TASK:

* ``solve`` — the fleet solver on a mesh (world 2: ``elastic_mesh(model=
  1)``, world 4: ``make_test_mesh()``): cold, warm and traffic solves of
  ``fleet()``, three problems of one bucket (padded to 4) on the port's
  stream and on the reference's draws from IN; at world 4 also a cold
  solve on a mesh of 3 of the 4 ranks, at world 2 a replan round and a
  3-round chaos service under a fake clock;
* ``moe`` — reduced mixtral's ``moe_apply(impl="a2a")`` and ``loss_fn``
  on ``make_test_mesh()`` from the reference's parameters in IN (the
  layer and the tensor-parallel model each holding the rank's slices of
  their specs), and the layer again on the multi-pod test mesh over
  ``("pod", "data")``;
* ``ref-moe`` (no rank: RANK WORLD STORE are ignored) — the reference's
  a2a on 4 forced host devices, for the ``moe`` comparison; the only task
  that imports JAX, with ``XLA_FLAGS`` set by the test;
* ``serve`` — every ``SERVE_CASES`` model tensor-parallel on the meshes
  of ``serve_meshes(world)`` (IN's ``cases``): weights from IN (the
  reference's, whole, cut to the rank's slices), the prefill of IN's batch and ``SERVE_STEPS``
  greedy decode steps, every step's logits and the tokens.

* ``seq-decode`` — batch-1 sequence-parallel serving on ``(WORLD, 1)``:
  every ``SEQ_CASES`` model from IN's weights (whole, cut to the rank's
  slices), the prefill of IN's one-row batch and greedy decode steps
  (every step's logits), ``Server.generate``'s tokens, and the slots of
  the rank's first KV cache;
* ``train`` — the train step and the ``Trainer`` on a mesh: at world 2
  on ``(2, 1)`` and ``(1, 2)``, at world 4 on ``(2, 2)``, every
  ``SERVE_CASES`` model's ``loss_fn`` over the rank's rows of IN's batch
  and its gradients summed over the data shards as the train step sums
  them; at world 2 also the ``TRAIN_RUNS`` trainers from IN's initial
  parameters and a crash after step 2 saved on ``(2, 1)`` and restored
  on ``(1, 2)``.

Imported by the tests for ``spawn``, the problems, the configs and the
input makers.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HELPER = Path(__file__).resolve()
#: seconds a spawned world may take (import, meet, solve, write)
SPAWN_TIMEOUT_S = 120

#: the solver tests' config: small, with every problem freezing at its
#: own iteration
CFG_KW = dict(pop_size=12, max_iters=24, stall_iters=8)
#: reduced mixtral's layer inputs: 64 tokens (every entry kept) and 10,240
#: (> 8,192: capacity dropping), in (batch, seq)
MOE_SHAPES = {"exact": (4, 16), "drop": (4, 2560)}
AUX_WEIGHT = 3.0


def child_env(**extra):
    """This environment with the repo's ``src`` on ``PYTHONPATH`` and
    ``extra`` on top, for a spawned process."""
    path = os.pathsep.join([str(HELPER.parent.parent / "src"),
                            os.environ.get("PYTHONPATH", "")])
    return {**os.environ, "PYTHONPATH": path, **extra}


def spawn(task, world, tmp, inputs):
    """Run ``world`` ranks of this script's TASK; their ``.npz`` results
    in rank order. A rank that fails or hangs fails the caller."""
    out = tmp / "out"
    procs = [subprocess.Popen(
        [sys.executable, str(HELPER), task, str(r), str(world),
         str(tmp / "store"), str(out), str(inputs)],
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r]}"
    return [dict(np.load(f"{out}-{r}.npz")) for r in range(world)]


def fleet(lib):
    """Five problems in two buckets: alexnet x3 (11 layers -> 16, not a
    multiple of 2 shards) and vgg19 x2 (25 -> 32)."""
    env = lib.paper_environment()
    out = []
    for i, (net, ratio) in enumerate((("alexnet", 2.0), ("vgg19", 1.5),
                                      ("alexnet", 3.0), ("vgg19", 2.5),
                                      ("alexnet", 1.2))):
        dag = lib.zoo.build(net, pin_server=i % 3)
        h, _ = lib.heft_makespan(dag, env)
        out.append((dag.with_deadline(np.array([ratio * h])), env))
    return out


def trio(lib):
    """Three alexnets of one bucket: N = 3 on 2 shards pads one row."""
    return fleet(lib)[0::2]


def arrivals_for(n, seed=23):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.uniform(0.0, 8.0, size=(2, 1, 3)), axis=-1)
            for _ in range(n)]


def moe_cfg(get):
    return dataclasses.replace(get("mixtral-8x7b").reduced(),
                               dtype="float32")


def moe_inputs(d_model, vocab):
    """Layer inputs and cotangent weights per regime, and a token batch
    for ``loss_fn`` (4 x 17: 64 positions after the labels' shift)."""
    rng = np.random.default_rng(5)
    out = {}
    for tag, (b, s) in MOE_SHAPES.items():
        out[f"x_{tag}"] = rng.standard_normal((b, s, d_model)).astype(
            np.float32)
        out[f"w_{tag}"] = rng.standard_normal((b, s, d_model)).astype(
            np.float32)
    out["tokens"] = rng.integers(2, vocab, (4, 17)).astype(np.int32)
    return out


#: the served cases: (arch, fields replaced in its reduced float32 config,
#: moe_impl). The fallbacks are reached on purpose: the reduced 4 q / 2 kv
#: heads replicate kv at tp 4; 6 q heads split over the d_model
#: contraction at tp 4 (6 q / 3 kv: uneven kv groups at tp 2); 6 experts
#: split each expert's d_ff at tp 4; d_ff 130 swaps the MLP's layout at tp 4
SERVE_CASES = {
    "dense": ("qwen3-0.6b", {}, "scatter"),
    "partial-q": ("qwen3-0.6b", {"n_heads": 6}, "scatter"),
    "uneven-kv": ("qwen3-0.6b", {"n_heads": 6, "n_kv_heads": 3}, "scatter"),
    "mlp-swap": ("starcoder2-3b", {"d_ff": 130}, "scatter"),
    "gemma3": ("gemma3-27b", {}, "scatter"),
    "moe": ("mixtral-8x7b", {}, "scatter"),
    "moe-ep_fsdp": ("mixtral-8x7b", {"moe_shard": "ep_fsdp"}, "scatter"),
    "moe-ep_only": ("mixtral-8x7b", {"moe_shard": "ep_only"}, "scatter"),
    "moe-ffn-tp": ("mixtral-8x7b", {"n_experts": 6}, "scatter"),
    "moe-a2a": ("mixtral-8x7b", {}, "a2a"),
    "arctic": ("arctic-480b", {}, "scatter"),
    "vlm": ("internvl2-2b", {}, "scatter"),
    "encdec": ("whisper-medium", {}, "scatter"),
    "ssm": ("mamba2-2.7b", {}, "scatter"),
    "hybrid": ("zamba2-7b", {}, "scatter"),
}
#: the served batch: 4 rows (2 a data shard) of 40 tokens, past the
#: reduced windows of 32 (whisper: 40 frames, 5 tokens; the VLM: 8 vision
#: embeddings and 32 tokens), then greedy decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 40, 3


def serve_cfg(get, case):
    arch, kw, impl = SERVE_CASES[case]
    return dataclasses.replace(get(arch).reduced(), dtype="float32",
                               **kw), impl


def serve_meshes(world):
    """``(data, model)`` shapes served at a world: 2 -> (1, 2), (2, 1);
    4 -> (1, 4), (2, 2)."""
    return [(1, world), (world // 2, 2) if world == 4 else (2, 1)]


def serve_start(cfg, batch):
    """The decode position after the prefill of ``batch``."""
    if cfg.family == "encdec":
        return batch["audio_embeds"].shape[1]
    n = batch["vision"].shape[1] if "vision" in batch else 0
    return n + batch["tokens"].shape[1]


#: the sequence-parallel cases: (arch, fields replaced in its reduced
#: float32 config, prompt length). A prompt of 40 and 8 new tokens (a cache
#: of 48 slots; gemma3's and mixtral's rings of 32 wrap); "short" (20 + 8:
#: 7 slots a rank at world 4) leaves rank 3 with no live slot at first
SEQ_CASES = {
    "qwen3": ("qwen3-0.6b", {}, 40),
    "gemma3": ("gemma3-27b", {}, 40),
    "mixtral": ("mixtral-8x7b", {}, 40),
    "zamba2": ("zamba2-7b", {}, 40),
    "whisper": ("whisper-medium", {}, 40),
    "int8": ("qwen3-0.6b", {"kv_dtype": "int8"}, 40),
    "short": ("qwen3-0.6b", {}, 20),
}
SEQ_NEW = 8


def seq_cfg(get, case):
    arch, kw, prompt = SEQ_CASES[case]
    return dataclasses.replace(get(arch).reduced(), dtype="float32",
                               **kw), prompt


def run_seq_decode(rank, world):
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.models import shard_state_dict
    inp = np.load(sys.argv[6])
    mesh = build_mesh(None, (world, 1), ("data", "model"), device="cpu")
    out = {}
    for case in SEQ_CASES:
        cfg, prompt = seq_cfg(get, case)
        srv = Server(cfg, 1, prompt, SEQ_NEW, eos_id=-1, mesh=mesh,
                     device="cpu")
        model = srv.model
        pre = f"{case}.param."
        full = {k[len(pre):]: torch.from_numpy(inp[k])
                for k in inp.files if k.startswith(pre)}
        model.load_state_dict(shard_state_dict(
            full, model.param_pspecs(), model.sh))
        pre = f"{case}.batch."
        batch = {k[len(pre):]: inp[k] for k in inp.files
                 if k.startswith(pre)}
        pos = serve_start(cfg, batch)
        with torch.inference_mode():
            lg, caches = model.prefill(batch, cache_len=prompt + SEQ_NEW)
            logits, toks = [lg], []
            for i in range(SEQ_NEW - 1):
                toks.append(lg[:, -1].argmax(-1)[:, None].int())
                lg, caches = model.decode_step(
                    caches, {"token": toks[-1].numpy(), "pos": pos + i})
                logits.append(lg)
            toks.append(lg[:, -1].argmax(-1)[:, None].int())
        out[f"{case}.logits"] = torch.cat(logits, 1).numpy()
        out[f"{case}.tokens"] = torch.cat(toks, 1).numpy()
        out[f"{case}.generate"] = srv.generate(batch)["tokens"]
        kv = caches["self"] if cfg.family == "encdec" else (
            caches["attn"] if cfg.family == "hybrid" else caches)
        while isinstance(kv, dict) and "k" not in kv:
            kv = next(iter(kv.values()))
        out[f"{case}.slots"] = np.array(kv["k"].shape[-3])
    return out


def run_serve(rank, world):
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import build_model, shard_state_dict
    inp = np.load(sys.argv[6])
    out = {}
    for shape in serve_meshes(world):
        mesh = build_mesh(None, shape, ("data", "model"), device="cpu")
        tag = "x".join(map(str, shape))
        for case in map(str, inp["cases"]):
            cfg, impl = serve_cfg(get, case)
            model = build_model(cfg, device="cpu", mesh=mesh, moe_impl=impl)
            pre = f"{case}.param."
            full = {k[len(pre):]: torch.from_numpy(inp[k])
                    for k in inp.files if k.startswith(pre)}
            model.load_state_dict(shard_state_dict(
                full, model.param_pspecs(), model.sh))
            pre = f"{case}.batch."
            batch = {k[len(pre):]: inp[k] for k in inp.files
                     if k.startswith(pre)}
            pos = serve_start(cfg, batch)
            with torch.inference_mode():
                lg, caches = model.prefill(batch, cache_len=pos
                                           + SERVE_STEPS)
                logits, toks = [lg], []
                for i in range(SERVE_STEPS):
                    toks.append(lg[:, -1].argmax(-1)[:, None].int())
                    lg, caches = model.decode_step(
                        caches, {"token": toks[-1].numpy(), "pos": pos + i})
                    logits.append(lg)
            out[f"{tag}.{case}.logits"] = torch.cat(logits, 1).numpy()
            out[f"{tag}.{case}.tokens"] = torch.cat(toks, 1).numpy()
    return out


#: the train batch's rows (2 a data shard) and length (17 tokens: 16
#: positions after the labels' shift; whisper: 16 frames and 9 tokens;
#: the VLM: 8 vision embeddings ahead of the tokens)
TRAIN_BATCH, TRAIN_SEQ = 4, 17
#: the trainers run on each mesh of world 2: TrainerConfig fields
TRAIN_RUNS = {"plain": {}, "accum": {"accum": 2},
              "compress": {"compress_grads": True}}
#: their model, shape and optimiser (``tests/test_torch_train_loop.py``'s)
TRAIN_STEPS, TRAIN_SHAPE = 6, (64, 4)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=24, weight_decay=0.01)


def train_meshes(world):
    """``(data, model)`` shapes trained at a world: 2 -> (2, 1), (1, 2);
    4 -> (2, 2), (1, 4) (the fallbacks of ``SERVE_CASES`` at tp 4)."""
    return [(2, 1), (1, 2)] if world == 2 else [(2, 2), (1, 4)]


def train_batch(cfg, seed):
    """``tests/test_torch_train_step.py``'s batch at ``TRAIN_BATCH`` rows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                        dtype=np.int32)
    if cfg.family == "encdec":
        return {"audio_embeds": rng.standard_normal(
            (TRAIN_BATCH, 16, cfg.d_model)).astype(np.float32),
            "tokens": toks[:, :9]}
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (TRAIN_BATCH, 8, cfg.d_model)).astype(np.float32),
            "tokens": toks}
    return {"tokens": toks}


def trainer_for(get, mesh, ckpt=None, fail_at=(), **kw):
    """The reduced qwen3 ``Trainer`` of the trainer cases (``mesh=None``:
    one device, no mesh)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureInjector
    tcfg = TrainerConfig(steps=TRAIN_STEPS, log_every=1, ckpt_dir=ckpt,
                         ckpt_every=2, keep_n=5, **kw)
    return Trainer(get("qwen3-0.6b").reduced(),
                   ShapeSpec("test", *TRAIN_SHAPE, "train"), tcfg,
                   AdamWConfig(**TRAIN_OPT), device="cpu", mesh=mesh,
                   injector=FailureInjector(fail_at=tuple(fail_at)))


def run_train(rank, world):
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.steps import MeshPlan
    from repro_torch.models import build_model, shard_state_dict
    from repro_torch.runtime import SimulatedFailure
    inp = np.load(sys.argv[6])
    out = {}

    def loaded(cfg, mesh, impl, pre):
        model = build_model(cfg, device="cpu", mesh=mesh, moe_impl=impl)
        full = {k[len(pre):]: torch.from_numpy(inp[k])
                for k in inp.files if k.startswith(pre)}
        model.load_state_dict(shard_state_dict(
            full, model.param_pspecs(), model.sh))
        return model.requires_grad_(True)

    for shape in train_meshes(world):
        mesh = build_mesh(None, shape, ("data", "model"), device="cpu")
        tag = "x".join(map(str, shape))
        for case in map(str, inp["cases"]):
            cfg, impl = serve_cfg(get, case)
            model = loaded(cfg, mesh, impl, f"{case}.param.")
            batch = {k[len(case) + 7:]: inp[k] for k in inp.files
                     if k.startswith(f"{case}.batch.")}
            loss, _ = model.loss_fn({k: model.sh.split_rows(v)
                                     for k, v in batch.items()},
                                    local_rows=True)
            loss.backward()
            plan = MeshPlan(model, ("data",), zero1=True)
            grads = plan.sum_data({n: w.grad for n, w in
                                   model.named_parameters()})
            out[f"{tag}.{case}.loss"] = loss.detach().numpy()
            for name, g in grads.items():
                out[f"{tag}.{case}.g.{name}"] = g.numpy()
                out[f"{tag}.{case}.slice.{name}"] = np.array(
                    [[i.start, i.stop] for i in model.sh.index(
                        plan.specs[name], plan.full[name])])
            if impl == "a2a":       # PR 22's whole-batch a2a loss_fn
                whole = loaded(cfg, mesh, impl, f"{case}.param.")
                wl, _ = whole.loss_fn(batch)
                wl.backward()
                out[f"{tag}.{case}.whole.loss"] = wl.detach().numpy()
                for name, w in whole.named_parameters():
                    out[f"{tag}.{case}.whole.g.{name}"] = w.grad.numpy()
    if world != 2:
        return out
    init = {k[len("trainer.param."):]: torch.from_numpy(inp[k])
            for k in inp.files if k.startswith("trainer.param.")}
    for shape in train_meshes(world):
        mesh = build_mesh(None, shape, ("data", "model"), device="cpu")
        tag = "x".join(map(str, shape))
        for run, kw in TRAIN_RUNS.items():
            t = trainer_for(get, mesh, **kw)
            t.init_params = init
            res = t.train()
            for f in ("loss", "grad_norm", "lr", "step"):
                out[f"{tag}.{run}.{f}"] = np.array(
                    [m[f] for m in res["metrics"]])
            opt = t._final[0] if kw.get("compress_grads") else t._final
            out[f"{tag}.{run}.mu_numel"] = np.array(
                sum(m.numel() for m in opt.mu.values()))
            out[f"{tag}.{run}.param_numel"] = np.array(
                sum(p.numel() for p in t.params.values()))
    # a crash after step 2's checkpoint on (2, 1), restored on (1, 2); a
    # copy of the checkpoints for the test's world-of-one restore
    ckpt = Path(sys.argv[6]).parent / "ckpt"
    crashy = trainer_for(get, build_mesh(None, (2, 1), ("data", "model"),
                                         device="cpu"),
                         ckpt=str(ckpt), fail_at=(3,))
    crashy.init_params = init
    try:
        crashy.train(max_restarts=0)
    except SimulatedFailure:
        pass
    crashy.mgr.wait()
    if rank == 0:
        shutil.copytree(ckpt, Path(sys.argv[6]).parent / "ckpt-one")
    dist.barrier()
    resumed = trainer_for(get, build_mesh(None, (1, 2), ("data", "model"),
                                          device="cpu"), ckpt=str(ckpt))
    res = resumed.train()
    out["resumed.loss"] = np.array([m["loss"] for m in res["metrics"]])
    out["resumed.step"] = np.array([m["step"] for m in res["metrics"]])
    out["crashed.step"] = np.array([m["step"] for m in
                                    crashy.metrics_log])
    return out


def _results(prefix, res, out):
    out[f"{prefix}.fit"] = np.array([r.best_fitness for r in res])
    out[f"{prefix}.cost"] = np.array([r.best_cost for r in res])
    out[f"{prefix}.it"] = np.array([r.iterations for r in res])
    out[f"{prefix}.feas"] = np.array([r.feasible for r in res])
    for i, r in enumerate(res):
        out[f"{prefix}.x{i}"] = np.asarray(r.best_x)


def run_solve(rank, world, mesh):
    import repro_torch.core as port
    from repro_torch.core.pso_ga import SwarmDraws
    from repro_torch.launch.plan import chaos_script
    cfg = port.PSOGAConfig(**CFG_KW)
    probs = fleet(port)
    n = len(probs)
    out = construct(world)
    cold = port.run_pso_ga_batch(probs, cfg, seed=list(range(n)),
                                 device="cpu", mesh=mesh)
    _results("cold", cold, out)
    if world == 4:
        # a mesh of 3 ranks: rank 3 solves nothing and gets every result
        from repro_torch.runtime import elastic_mesh
        three = elastic_mesh(1, devices=range(3), device="cpu")
        _results("outside", port.run_pso_ga_batch(
            probs, cfg, seed=list(range(n)), device="cpu", mesh=three), out)
    inc = [r.best_x for r in cold]
    rescue = [i % 2 == 0 for i in range(n)]
    warm, state = port.run_pso_ga_batch(
        probs, cfg, seed=9, device="cpu", incumbent=inc,
        migration_weight=1.0, warm_rescue=rescue, return_state=True,
        mesh=mesh)
    _results("warm", warm, out)
    out["warm.stall"] = state.stall.numpy()
    out["warm.X"] = state.X.numpy()
    traffic = port.run_pso_ga_batch(probs, cfg, seed=6, device="cpu",
                                    arrivals=arrivals_for(n), mesh=mesh)
    _results("traffic", traffic, out)
    three = trio(port)
    _results("trio", port.run_pso_ga_batch(three, cfg, seed=[1, 2, 3],
                                           device="cpu", mesh=mesh), out)
    inp = np.load(sys.argv[6])

    def draw_fn(i, step):
        return SwarmDraws(*(inp[f"draw{i}.{f}"][step]
                            for f in SwarmDraws._fields))
    _results("legacy", port.run_pso_ga_batch(
        three, cfg, seed=[1, 2, 3], device="cpu",
        X0=[inp[f"X0.{i}"] for i in range(3)], draw_fn=draw_fn,
        mesh=mesh), out)
    if world == 2:
        env, dags = probs[0][1], [d for d, _ in probs]
        drifted = port.sample_trace("congestion", env, rounds=2, seed=3)
        sp = [port.SimProblem.build(d, drifted.env_at(1)) for d in dags]
        plans, log = port.replan_round(
            sp, inc, port.ReplanConfig(pso=cfg, mesh=mesh), seed=5,
            round_no=1, device="cpu")
        for i, x in enumerate(plans):
            out[f"replan.x{i}"] = np.asarray(x)
        for f in ("replanned", "incumbent_key", "candidate_key", "cost",
                  "iterations", "demoted"):
            out[f"replan.{f}"] = np.asarray(getattr(log, f))
        rep = run_service(port, dags, env, cfg, mesh, chaos_script)
        for i, x in enumerate(rep.plans):
            out[f"service.x{i}"] = np.asarray(x)
        out["service.rungs"] = np.array([r.rung for r in rep.rounds])
        out["service.walls"] = np.array([r.wall_s for r in rep.rounds])
        out["service.counters"] = np.array(sorted(rep.counters.items()))
    return out


def construct(world):
    """The meshes of this world: ``elastic_mesh`` with model 1 and 2, over
    the first 3 ranks, and the multi-pod test mesh (or its error)."""
    from repro_torch.launch.mesh import (data_index, data_shard_count,
                                         make_test_mesh)
    from repro_torch.runtime import elastic_mesh
    out = {}
    for tag, build in (("elastic1", lambda: elastic_mesh(1, device="cpu")),
                       ("elastic2", lambda: elastic_mesh(2, device="cpu")),
                       ("elastic3", lambda: elastic_mesh(
                           1, devices=range(min(3, world)), device="cpu")),
                       ("pod", lambda: make_test_mesh(multi_pod=True,
                                                      device="cpu"))):
        try:
            m = build()
        except ValueError as e:
            out[f"{tag}.error"] = np.array(str(e))
            continue
        out[f"{tag}.shape"] = np.array(m.shape)
        out[f"{tag}.names"] = np.array(m.mesh_dim_names)
        out[f"{tag}.shards"] = np.array(data_shard_count(m))
        idx = data_index(m)
        out[f"{tag}.index"] = np.array(-1 if idx is None else idx)
    return out


def run_service(port, dags, env, cfg, mesh, chaos_script):
    """A 3-round congestion service under the ``--chaos`` script with the
    plan cache, walls from a fake clock."""
    class FakeClock:
        t = 0.0

        def __call__(self):
            self.t += 0.001
            return self.t
    trace = port.sample_trace("congestion", env, rounds=3, seed=0)
    scfg = port.ServiceConfig(
        replan=port.ReplanConfig(pso=cfg, mesh=mesh),
        chaos=chaos_script(3), plan_cache=port.PlanCacheConfig())
    return port.run_service(dags, trace, scfg, seed=0, device="cpu",
                            sleeper=lambda s: None,
                            telemetry=port.Telemetry(clock=FakeClock()))


def run_moe(rank, world, mesh):
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import (Sharding, build_model, moe_apply,
                                    shard_state_dict)
    from repro_torch.models.moe import MoE
    cfg = moe_cfg(get)
    inp = np.load(sys.argv[6])
    out = {}
    # the layer on the mesh: each bank the rank's slice of moe_pspec's
    # layout (its experts over the model axis, cfg.moe_shard's second
    # shard over the data axis), reported as [start, stop) per dimension
    layer = MoE(cfg, torch.float32, torch.device("cpu"), sh=Sharding(mesh))
    full = {k[len("layer."):]: torch.from_numpy(inp[k])
            for k in inp.files if k.startswith("layer.")}
    layer.load_state_dict(shard_state_dict(full, layer.spec, layer.sh))
    for name, w in layer.named_parameters():
        w.requires_grad_(True)
        out[f"layer_slice.{name}"] = np.array(
            [[i.start, i.stop] for i in layer.sh.index(layer.spec[name],
                                                        full[name].shape)])
    # the (2, 2) test mesh over ("data",), and the multi-pod test mesh
    # (pod 2, data 1, model 2) over ("pod", "data"): the same split
    pod = make_test_mesh(multi_pod=True, device="cpu")
    for mesh_, axes, prefix in ((mesh, ("data",), ""),
                                (pod, ("pod", "data"), "pod.")):
        for tag in MOE_SHAPES:
            x = torch.from_numpy(inp[f"x_{tag}"]).requires_grad_(True)
            y, aux = moe_apply(layer, x, cfg, impl="a2a", mesh=mesh_,
                               data_axes=axes)
            (torch.sum(y * torch.from_numpy(inp[f"w_{tag}"]))
             + AUX_WEIGHT * aux).backward()
            tag = prefix + tag
            out[f"{tag}.y"], out[f"{tag}.aux"] = y.detach().numpy(), \
                aux.detach().numpy()
            out[f"{tag}.gx"] = x.grad.numpy()
            for name, w in layer.named_parameters():
                out[f"{tag}.g.{name}"] = w.grad.numpy()
                w.grad = None
    # the model on the mesh: attention tensor-parallel over the model axis,
    # each parameter the rank's slice of its spec (reported as [start,
    # stop) per dimension, a cross-check of the test's own cut)
    model = build_model(cfg, device="cpu", mesh=mesh, moe_impl="a2a")
    state = {k[len("model."):]: torch.from_numpy(inp[k])
             for k in inp.files if k.startswith("model.")}
    specs = model.param_pspecs()
    model.load_state_dict(shard_state_dict(state, specs, model.sh))
    model.requires_grad_(True)
    loss, metrics = model.loss_fn({"tokens": inp["tokens"]})
    loss.backward()
    out["loss"], out["loss.aux"] = loss.detach().numpy(), \
        metrics["aux"].detach().numpy()
    for name, w in model.named_parameters():
        out[f"grad.{name}"] = w.grad.numpy()
        out[f"slice.{name}"] = np.array(
            [[i.start, i.stop] for i in model.sh.index(specs[name],
                                                        state[name].shape)])
    return out


def run_ref_moe(inp_path, out_path):
    """The reference's a2a on a (2, 2) mesh of forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get
    from repro.launch.mesh import make_test_mesh
    from repro.models import build_model
    from repro.models import moe as ref_moe
    assert jax.device_count() == 4, jax.devices()
    cfg = moe_cfg(get)
    mesh = make_test_mesh()
    inp = np.load(inp_path)
    p = {k[len("layer."):]: jnp.asarray(inp[k]) for k in inp.files
         if k.startswith("layer.")}
    out = {}
    for tag in MOE_SHAPES:
        x, w = jnp.asarray(inp[f"x_{tag}"]), jnp.asarray(inp[f"w_{tag}"])

        def f(p, x):
            y, aux = ref_moe.moe_apply(p, x, cfg, impl="a2a", mesh=mesh)
            return jnp.sum(y * w) + AUX_WEIGHT * aux, (y, aux)
        with mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        out[f"{tag}.y"], out[f"{tag}.aux"] = np.asarray(y), np.asarray(aux)
        out[f"{tag}.gx"] = np.asarray(gx)
        for name, g in gp.items():
            out[f"{tag}.g.{name}"] = np.asarray(g)
    model = build_model(cfg, mesh=mesh, data_axes=("data",),
                        moe_impl="a2a")
    params = jax.tree.map(jnp.asarray, _unflatten(
        {k[len("tree."):]: inp[k] for k in inp.files
         if k.startswith("tree.")}))
    with mesh:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(
                params, {"tokens": jnp.asarray(inp["tokens"])})
    out["loss"], out["loss.aux"] = np.asarray(loss), \
        np.asarray(metrics["aux"])
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out["tree." + "/".join(k.key for k in path)] = np.asarray(g)
    np.savez(out_path, **out)


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def main():
    task = sys.argv[1]
    if task == "ref-moe":
        run_ref_moe(sys.argv[6], sys.argv[5])
        return
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[4], world),
                            rank=rank, world_size=world)
    if task in ("serve", "seq-decode", "train"):
        run = {"serve": run_serve, "seq-decode": run_seq_decode,
               "train": run_train}[task]
        np.savez(f"{sys.argv[5]}-{rank}.npz", **run(rank, world))
        dist.destroy_process_group()
        return
    from repro_torch.launch.mesh import data_index, make_test_mesh
    from repro_torch.runtime import elastic_mesh
    mesh = elastic_mesh(model=1, device="cpu") if world == 2 \
        else make_test_mesh(device="cpu")
    out = (run_solve if task == "solve" else run_moe)(rank, world, mesh)
    out["data_index"] = np.array(data_index(mesh))
    out["mesh_shape"] = np.array(mesh.shape)
    np.savez(f"{sys.argv[5]}-{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
