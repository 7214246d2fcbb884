"""The port's dry run and roofline analysis (``repro_torch.launch.analysis``,
``repro_torch.launch.dryrun``) against the reference's, on the CPU.

- The reference's parser units (``tests/test_dryrun.py``), on the port's
  H100 figures.
- ``parse_hlo_collectives``, ``collective_bytes`` (pod size 0 and 8) and
  ``roofline_terms`` equal to the reference's on ``HLO_SAMPLE`` and on 50
  seeded collective lines in both replica-group formats, with and without
  a transpose; the port's ``Collective`` records priced as the reference
  prices the same groups written as explicit lists.
- ``record_collectives`` on a fake world of 4 ranks (a subprocess):
  reduced qwen3's prefill on ``(1, 2)`` issues PERF.md's tensor-parallel
  serving collectives exactly, and the ``(2, 2)`` train step's records
  hold ``MeshPlan``'s gradient sum, ZeRO-1 gathers and norm sum.
- One step traced on ``meta`` and run on the CPU, world of one, reduced
  float32 configs: equal FLOPs, bytes, kernel calls, collectives and peak.
- B3, B4 and B5 on ``meta``: the kernels' output shapes and layouts, no
  launch; one kernel call under ``trace_step`` is its ``cost`` alone.
- Mini dry runs as subprocesses on 8 fake ranks, as the reference's: the
  test mesh, the multi-pod test mesh and a skipped cell; the records'
  parameter and model-FLOP counts equal the reference's, and every
  skipped cell of the matrix has the reference's reason.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get as ref_get
from repro.configs import names as ref_names
from repro.launch import analysis as ref
from repro.models import model_flops as ref_model_flops
from repro.models import param_count as ref_param_count
from repro.models import skip_reason as ref_skip_reason
from repro.models import supports_shape as ref_supports_shape
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.collectives import Collective
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan
from repro_torch.launch import analysis
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.steps import (make_decode_objects,
                                      make_prefill_objects,
                                      make_train_objects)
from repro_torch.models import cache_len_for
from repro_torch.optim import adamw_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

HLO_SAMPLE = """
  %ag = bf16[4096,3072]{1,0} all-gather(bf16[256,3072]{1,0} %x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[] all-reduce(f32[] %y), channel_id=1, replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[64,128]{1,0} reduce-scatter(f32[1024,128]{1,0} %z), replica_groups=[1,16]<=[16], dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(bf16[8,8]{1,0} %w), source_target_pairs={{0,1}}
  %aa = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-to-all(f32[16,16]{1,0} %a, f32[16,16]{1,0} %b), replica_groups=[2,8]<=[16]
"""
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")


# ---------------------------------------------------------------------------
# the reference's parser units, on the port
# ---------------------------------------------------------------------------

def test_parse_hlo_collectives():
    ops = analysis.parse_hlo_collectives(HLO_SAMPLE)
    assert [o[0] for o in ops] == ["all-gather", "all-reduce",
                                   "reduce-scatter", "collective-permute",
                                   "all-to-all"]
    assert ops[0][1] == 4096 * 3072 * 2 and ops[0][2] == 16
    assert ops[1][1] == 4 and ops[1][2] == 4
    assert ops[4][1] == 2 * 16 * 16 * 4


def test_collective_bytes_accounting():
    stats = analysis.collective_bytes(HLO_SAMPLE)
    assert stats.count == 5 and stats.total_dcn == 0.0
    ag = 15 / 16 * 4096 * 3072 * 2
    assert abs(stats.per_op["all-gather"] - ag) < 1.0


def test_pod_crossing_detection():
    hlo = ("%ar = f32[128]{0} all-reduce(f32[128]{0} %x), "
           "replica_groups={{0,8}}, to_apply=%add")
    stats = analysis.collective_bytes(hlo, pod_size=8)
    assert stats.total_dcn > 0 and stats.total_ici == 0.0
    assert analysis.collective_bytes(hlo, pod_size=0).total_dcn == 0.0
    recs = [Collective("all-reduce", 512, (0, 8))]
    stats = analysis.collective_bytes(recs, pod_size=8)
    assert stats.total_dcn > 0 and stats.total_ici == 0.0


def test_roofline_terms_dominant():
    hw = analysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dcn_bw, hw.hbm_bytes) \
        == (989e12, 3.35e12, 450e9, 50e9, 80e9)
    t = analysis.roofline_terms(989e12, 3.35e12 * 0.1,
                                analysis.collective_bytes(""))
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute"


# ---------------------------------------------------------------------------
# exact parity with the reference
# ---------------------------------------------------------------------------

def _random_hlo(n: int = 50, seed: int = 0) -> str:
    """``n`` collective lines: every op, dtypes, tuples, ``-start``
    forms, iota groups with and without a transpose, explicit lists."""
    rng = np.random.default_rng(seed)
    dts = ("bf16", "f32", "s32", "u8", "pred", "f16", "s64", "f8e4m3fn")
    lines = []
    for i in range(n):
        op = OPS[rng.integers(len(OPS))]
        dt = dts[rng.integers(len(dts))]
        dims = ",".join(str(int(d)) for d in
                        rng.integers(1, 700, size=rng.integers(0, 4)))
        res = f"{dt}[{dims}]{{0}}"
        if rng.random() < 0.2:
            res = f"({res}, f32[{int(rng.integers(1, 99))},8]{{1,0}})"
        fleet = int(rng.choice([16, 64, 256, 512]))
        kind = rng.integers(3)
        if kind == 0:
            s = int(rng.choice([2, 4, 8, 16]))
            groups = f"replica_groups=[{fleet // s},{s}]<=[{fleet}]"
        elif kind == 1:
            s = int(rng.choice([2, 4, 8, 16]))
            groups = (f"replica_groups=[{fleet // s},{s}]<=[{s},"
                      f"{fleet // s}]T(1,0)")
        else:
            size = int(rng.integers(1, 9))
            ids = sorted(int(x) for x in rng.choice(fleet, size,
                                                    replace=False))
            groups = "replica_groups={{" + ",".join(map(str, ids)) + "}}"
        start = "-start" if rng.random() < 0.2 else ""
        lines.append(f"  %c{i} = {res} {op}{start}({dt}[4]{{0}} %a{i}), "
                     f"channel_id={i}, {groups}, to_apply=%add")
    return "\n".join(lines)


def _ref_hw():
    h = ref.HW()
    return analysis.HW(peak_flops=h.peak_flops, hbm_bw=h.hbm_bw,
                       ici_bw=h.ici_bw, dcn_bw=h.dcn_bw,
                       hbm_bytes=h.hbm_bytes)


def _stats(s):
    return (s.per_op, s.total_ici, s.total_dcn, s.count, s.total)


@pytest.mark.parametrize("pod_size", [0, 8])
@pytest.mark.parametrize("text", ["sample", "random"])
def test_analysis_equals_reference(text, pod_size):
    hlo = HLO_SAMPLE if text == "sample" else _random_hlo()
    assert analysis.parse_hlo_collectives(hlo) \
        == ref.parse_hlo_collectives(hlo)
    mine, theirs = (analysis.collective_bytes(hlo, pod_size=pod_size),
                    ref.collective_bytes(hlo, pod_size=pod_size))
    assert _stats(mine) == _stats(theirs)
    for flops, nbytes in ((1.3e14, 2.2e11), (7e9, 9e12), (0.0, 0.0)):
        assert analysis.roofline_terms(flops, nbytes, mine, _ref_hw()) \
            == ref.roofline_terms(flops, nbytes, theirs, ref.HW())


@pytest.mark.parametrize("pod_size", [0, 8])
def test_records_priced_as_explicit_groups(pod_size):
    """A ``Collective`` record prices as the reference prices its group
    written as an explicit list (the result as ``u8[bytes]``)."""
    rng = np.random.default_rng(1)
    recs, lines = [], []
    for i in range(40):
        op = OPS[rng.integers(len(OPS))]
        nbytes = int(rng.integers(1, 1 << 24))
        ranks = tuple(sorted(int(x) for x in rng.choice(
            32, int(rng.integers(1, 9)), replace=False)))
        recs.append(Collective(op, nbytes, ranks))
        lines.append(f"  %c{i} = u8[{nbytes}]{{0}} {op}(u8[1]{{0}} %a), "
                     "replica_groups={{" + ",".join(map(str, ranks))
                     + "}}")
    assert _stats(analysis.collective_bytes(recs, pod_size=pod_size)) \
        == _stats(ref.collective_bytes("\n".join(lines), pod_size=pod_size))


# ---------------------------------------------------------------------------
# subprocesses: the collective records on a fake world, mini dry runs
# ---------------------------------------------------------------------------

RECORDS_SCRIPT = """
import dataclasses, json, torch
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.analysis import trace_step
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import build_mesh
from repro_torch.launch.steps import make_prefill_objects, make_train_objects
from repro_torch.optim import adamw_init
fake_world(4)
cfg = dataclasses.replace(get("qwen3-0.6b").reduced(), n_layers=2)
out = {}
mesh = build_mesh([0, 1], (1, 2), ("data", "model"), device="cpu")
model, step, _ = make_prefill_objects(cfg, ShapeSpec("p", 16, 2, "prefill"),
                                      device="meta", mesh=mesh)
_, c = trace_step(step, {"tokens": torch.zeros((2, 16), dtype=torch.int32,
                                                device="meta")},
                  live=list(model.parameters()))
out["prefill"] = [list(r) for r in c.collectives]
mesh = build_mesh(None, (2, 2), ("data", "model"), device="cpu")
model, step, _ = make_train_objects(cfg, ShapeSpec("t", 16, 4, "train"),
                                    device="meta", mesh=mesh)
plan = step.plan
opt = adamw_init({n: plan.zslice(n, p) for n, p in model.named_parameters()})
_, c = trace_step(step, opt, {"tokens": torch.zeros((4, 17),
                                                    dtype=torch.int32,
                                                    device="meta")},
                  live=list(model.parameters()))
out["train"] = [list(r) for r in c.collectives]
params = dict(model.named_parameters())
out["summed"] = 4 * sum(params[n].numel() for n, a in plan.sum_axes.items()
                        if a)
out["zero"] = sorted(params[n].element_size() * params[n].numel()
                     for n, z in plan.zero.items() if z is not None)
print(json.dumps(out))
"""

MINI_RUNS = {
    "single": ["--arch", "qwen3-0.6b", "--shape", "decode_32k",
               "--test-mesh"],
    "multi": ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--test-mesh",
              "--multi-pod"],
    "skip": ["--arch", "gemma-7b", "--shape", "long_500k", "--test-mesh"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file, started together: the records
    script and the mini dry runs on 8 fake ranks (the reference's
    ``REPRO_DRYRUN_DEVICES=8``)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="8")
    procs = {"records": subprocess.Popen(
        [sys.executable, "-c", RECORDS_SCRIPT], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)}
    for name, args in MINI_RUNS.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(tmp / f"{name}.json")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, (name, so, se)
        out[name] = json.loads(so.strip().splitlines()[-1]) \
            if name == "records" else json.loads(
                (tmp / f"{name}.json").read_text())
    return out


def test_tp_prefill_records(runs):
    """PERF.md §3's tensor-parallel serving row, exactly: per layer 2 sums
    of the (B·S·d) partial outputs, 1 for the vocab-parallel lookup, and
    1 gather of the (B, 1, V/tp) logits (float32, B 2, S 16, d 64, V 256,
    the model group's ranks 0 and 1)."""
    cfg = dataclasses.replace(get("qwen3-0.6b").reduced(), n_layers=2)
    row = 2 * 16 * cfg.d_model * 4
    want = [["all-reduce", row, [0, 1]]] * (1 + 2 * cfg.n_layers) \
        + [["all-gather", 2 * 1 * cfg.vocab * 4, [0, 1]]]
    assert runs["records"]["prefill"] == want


def test_mesh_train_records(runs):
    """``MeshPlan`` on ``(2, 2)``: one all-reduce of every gradient summed
    over the data axis (float32 here), one all-gather over the data group
    per ZeRO-1 slice, each the parameter's whole bytes, and the clipping
    norm's float32 partial summed over the model group."""
    got = runs["records"]
    recs = [(op, b, tuple(g)) for op, b, g in got["train"]]
    data, model = (0, 2), (0, 1)            # rank 0's groups on [[0, 1], [2, 3]]
    assert ("all-reduce", got["summed"], data) in recs
    assert sorted(b for op, b, g in recs if op == "all-gather"
                  and g == data) == got["zero"]
    assert len(got["zero"]) > 10
    assert ("all-reduce", 4, model) in recs


def test_mini_dryrun_single_pod(runs):
    rec = runs["single"]
    assert rec["status"] == "ok"
    assert rec["mesh"] == {"data": 4, "model": 2}
    assert rec["n_chips"] == 8 and rec["flops_per_chip"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["kernel_calls"]["decode_attention"]["calls"] == 28
    assert rec["memory"]["code_bytes"] == 0.0 and "hlo_bytes" not in rec
    cfg, shape = ref_get("qwen3-0.6b"), next(
        s for s in REF_SHAPES if s.name == "decode_32k")
    assert rec["params_total"] == ref_param_count(cfg)
    assert rec["params_active"] == ref_param_count(cfg, active_only=True)
    assert rec["model_flops_total"] == ref_model_flops(cfg, shape)


def test_mini_dryrun_multi_pod(runs):
    rec = runs["multi"]
    assert rec["status"] == "ok"
    assert rec["mesh"] == {"pod": 2, "data": 2, "model": 2}


def test_mini_dryrun_skips_long_context_full_attn(runs):
    rec = runs["skip"]
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_skip_reason(
        ref_get("gemma-7b"), next(s for s in REF_SHAPES
                                  if s.name == "long_500k"))


SKIPPED = [(a, s.name) for a in ref_names() for s in REF_SHAPES
           if not ref_supports_shape(ref_get(a), s)]


@pytest.mark.parametrize("arch,shape", SKIPPED)
def test_skipped_cells_match_reference(arch, shape):
    """Every cell the reference skips is skipped with its reason (no world
    is started for a skipped cell)."""
    rec = run_cell(arch, shape)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_skip_reason(
        ref_get(arch), next(s for s in REF_SHAPES if s.name == shape))


# ---------------------------------------------------------------------------
# meta against a real CPU step
# ---------------------------------------------------------------------------

def _step(kind: str, arch: str, dev: str):
    cfg = dataclasses.replace(get(arch).reduced(), n_layers=2)
    b, s = 2, 40
    tok = torch.zeros if dev == "meta" else (
        lambda shape, **kw: torch.randint(0, cfg.vocab, shape, **kw,
                                          generator=torch.Generator()
                                          .manual_seed(0)))
    if kind == "prefill":
        model, step, _ = make_prefill_objects(
            cfg, ShapeSpec("p", s, b, "prefill"), device=dev)
        args = ({"tokens": tok((b, s), dtype=torch.int32, device=dev)},)
    elif kind == "decode":
        shape = ShapeSpec("d", s, b, "decode")
        model, step, _ = make_decode_objects(cfg, shape, device=dev)
        args = (model.init_caches(b, cache_len_for(cfg, shape)),
                {"token": tok((b, 1), dtype=torch.int32, device=dev),
                 "pos": s - 1})
    else:
        model, step, _ = make_train_objects(
            cfg, ShapeSpec("t", s, b, "train"), device=dev)
        opt = adamw_init({n: step.plan.zslice(n, p)
                          for n, p in model.named_parameters()})
        args = (opt, {"tokens": tok((b, s + 1), dtype=torch.int32,
                                    device=dev)})
    if dev != "meta":
        model.init(torch.Generator().manual_seed(0))
    _, cost = analysis.trace_step(step, *args,
                                  live=[*model.parameters(),
                                        *model.buffers()])
    return cost


@pytest.mark.parametrize("kind,arch,kernels", [
    ("prefill", "qwen3-0.6b", {"flash_attention": 2}),
    ("decode", "qwen3-0.6b", {"decode_attention": 2}),
    ("train", "qwen3-0.6b", {}),
    ("prefill", "mamba2-2.7b", {"ssd_scan": 2})])
def test_meta_trace_equals_cpu_step(kind, arch, kernels):
    cpu, meta = _step(kind, arch, "cpu"), _step(kind, arch, "meta")
    assert meta.counts() == cpu.counts()
    assert {n: k["calls"] for n, k in meta.kernels_by_name().items()} \
        == kernels
    assert meta.flops == meta.matmul_flops + meta.kernel_flops > 0
    assert meta.peak_bytes == meta.argument_bytes + meta.output_bytes \
        - meta.alias_bytes + meta.temp_bytes
    assert meta.temp_bytes >= 0 and meta.collectives == []
    assert sum(meta.peak_by_op.values()) \
        == meta.peak_bytes - meta.argument_bytes


# ---------------------------------------------------------------------------
# the kernels' meta route and cost
# ---------------------------------------------------------------------------

def _kernel_case(name: str, dev: str):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(dev)
    if name == "flash":
        q, k, v = r(2, 24, 2, 3, 16), r(2, 24, 2, 16), r(2, 24, 2, 16)
        args = (q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3))
        return fa.flash_attention_folded, fa.cost, args, dict(
            causal=True, window=7)
    if name in ("decode", "decode-lse"):
        q, k, v = r(2, 2, 3, 16), r(2, 30, 2, 16), r(2, 30, 2, 16)
        return da.decode_attention_folded, da.cost, (
            q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), 17), dict(
            return_lse=name == "decode-lse")
    xc, cum = r(3, 16, 2, 8), r(3, 16, 2)
    bc = r(3, 16, 8)
    return ssd_scan.ssd_intra_folded, ssd_scan.cost, (xc, cum, bc, bc + 1), {}


@pytest.mark.parametrize("name", ["flash", "decode", "decode-lse", "ssd"])
def test_meta_route_is_the_kernels_output(name):
    """On ``meta`` a kernel's dispatch returns what its launch would
    allocate (the CPU route's shapes, dtypes and strides) without counting
    a launch; traced, a call on either device is its ``cost`` and its
    outputs, none of the plain version's operators."""
    fn, cost, args, kw = _kernel_case(name, "cpu")
    margs = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                  for a in args)
    launches = fn.launches
    outs = [fn(*a, **kw) for a in (args, margs)]
    assert fn.launches == launches
    got = [o if isinstance(o, tuple) else (o,) for o in outs]
    assert [(t.shape, t.dtype, t.stride()) for t in got[0]] \
        == [(t.shape, t.dtype, t.stride()) for t in got[1]]
    traces = [analysis.trace_step(fn, *a, **kw)[1] for a in (args, margs)]
    assert traces[0].counts() == traces[1].counts()
    c = traces[1]
    work = cost(*margs, **kw)
    assert c.ops == 0 and len(c.kernel_calls) == 1
    assert (c.flops, c.bytes) == (work["flops"], work["bytes"])
    assert c.kernel_calls[0]["out_bytes"] == sum(
        t.numel() * t.element_size() for t in got[1])
    assert c.peak_bytes == c.argument_bytes + c.kernel_calls[0]["out_bytes"]


@pytest.mark.parametrize("S", [1, 5, 40, 333])
def test_band_pairs(S):
    for causal in (True, False):
        for window in (0, 1, 3, 40, 500):
            q = np.arange(S)
            lo = np.maximum(0, q - window + 1) if window else 0 * q
            hi = q + 1 if causal else S + 0 * q
            assert fa.band_pairs(S, causal, window) == int((hi - lo).sum())
