"""The port's sharding specs against the reference's, as pure functions
(no process group, no weights).

Every registered config at model-axis sizes None (no mesh), 1, 2, 4, 8
and 16: ``param_pspecs`` (the port's keys are its state dict's names; the
reference's stacked leaves carry one leading ``None`` per layer axis,
dropped for the comparison), ``cache_pspecs`` with and without
``shard_seq`` and with bf16 and int8 caches (the port's caches are
stacked as the reference's, so the trees are compared whole), and
``batch_pspecs`` for every shape, all equal to the reference's exactly as
``PartitionSpec`` tuples; then each spec helper over a grid of its
arguments. The models are built on the ``meta`` device over a stand-in
mesh (the reference reads only a mesh's axis names and sizes; the port
also this rank's coordinates), and each port parameter's shape is checked
against its spec's slice of the unsharded shape. Last, the serving
fallbacks that ``tests/test_torch_serve_mesh.py`` reaches are shown to be
the layouts they are named for.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get as ref_get
from repro.configs import names
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models.model_zoo import batch_pspecs as ref_batch_pspecs
from repro_torch.configs import SHAPES, get
from repro_torch.models import attention as attn
from repro_torch.models import batch_pspecs, build_model, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import NO_MESH, Sharding

TPS = [None, 1, 2, 4, 8, 16]
ARCHS = list(names())


class PortMesh:
    """What a ``DeviceMesh`` tells a model: axis names, sizes and this
    rank's coordinates."""

    def __init__(self, shape, coord, names=("data", "model")):
        self.mesh_dim_names, self.shape, self._coord = names, shape, coord

    def get_coordinate(self):
        return list(self._coord)


class RefMesh:
    """What the reference's models read of a ``jax.sharding.Mesh``."""

    def __init__(self, tp):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": tp}


def _t(spec):
    return tuple(spec)


def _flat(tree, path=()):
    """(path, spec tuple) leaves of a spec tree (dicts, tuples, lists)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif type(tree) in (tuple, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, _t(tree)


def _models(arch, tp, rank=0, **kw):
    cfg = dataclasses.replace(get(arch), **kw)
    rcfg = dataclasses.replace(ref_get(arch), **kw)
    mesh = None if tp is None else PortMesh((1, tp), (0, rank))
    port = build_model(cfg, device="meta", mesh=mesh)
    ref = ref_build(rcfg, mesh=None if tp is None else RefMesh(tp))
    return cfg, port, ref


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, tp):
    """Every port parameter's spec is its reference leaf's without the
    leading layer axes, every reference leaf is some port parameter's,
    and each parameter holds its spec's slice of the unsharded shape."""
    cfg, port, ref = _models(arch, tp, rank=(tp or 1) - 1)
    specs = port.param_pspecs()
    want = dict(_flat(ref.param_pspecs()))
    seen = set()
    for name, spec in specs.items():
        parts = name.split(".")
        key = tuple(p for p in parts if not p.isdigit())
        lead = len(parts) - len(key)
        assert key in want, name
        assert want[key][:lead] == (None,) * lead, (name, want[key])
        assert _t(spec) == want[key][lead:], (name, spec, want[key])
        seen.add(key)
    assert seen == set(want)
    full = dict(build_model(cfg, device="meta").named_parameters())
    local = dict(port.named_parameters())
    assert sorted(local) == sorted(specs) == sorted(full)
    for name, w in local.items():
        assert tuple(w.shape) == port.sh.local_shape(
            specs[name], full[name].shape), name


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, tp, shard_seq, kv):
    _, port, ref = _models(arch, tp, kv_dtype=kv)
    assert list(_flat(port.cache_pspecs(shard_seq))) == \
        list(_flat(ref.cache_pspecs(shard_seq)))


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")],
                         ids=["data", "pod-data"])
@pytest.mark.parametrize("shape", range(len(SHAPES)),
                         ids=[s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_reference(arch, shape, axes):
    got = batch_pspecs(get(arch), SHAPES[shape], axes)
    want = ref_batch_pspecs(ref_get(arch), REF_SHAPES[shape], axes)
    assert {k: _t(v) for k, v in got.items()} == \
        {k: _t(v) for k, v in want.items()}


def test_divisible_and_embed_pspec():
    for n in (1, 8, 32_000, 51_865, 92_553, 151_936):
        for tp in TPS + [3, 0]:
            assert layers.divisible(n, tp) == ref_layers.divisible(n, tp)
            if tp != 0:
                assert _t(layers.embed_pspec(n, tp)) == \
                    _t(ref_layers.embed_pspec(n, tp))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_pspec(act):
    for d_ff in (0, 128, 130, 14336):
        for tp in TPS:
            got = layers.mlp_pspec(act, d_ff, tp)
            want = ref_layers.mlp_pspec(act, d_ff, tp)
            assert {k: _t(v) for k, v in got.items()} == \
                {k: _t(v) for k, v in want.items()}


def _grid():
    for arch in ARCHS:
        for kw in ({}, {"n_heads": 6}, {"n_heads": 6, "n_kv_heads": 3},
                   {"n_experts": 6}, {"moe_shard": "ep_fsdp"},
                   {"moe_shard": "ep_only"}):
            cfg = dataclasses.replace(get(arch), **kw)
            rcfg = dataclasses.replace(ref_get(arch), **kw)
            for tp in TPS:
                yield cfg, rcfg, tp


def test_attn_moe_mamba_pspecs():
    """``attn_pspec``, ``moe_pspec`` and ``mamba_pspec`` over every
    config, the fallbacks' head and expert counts and each ``moe_shard``,
    at every model-axis size."""
    n = 0
    for cfg, rcfg, tp in _grid():
        pairs = [(attn.attn_pspec(cfg, tp), ref_attn.attn_pspec(rcfg, tp))]
        if cfg.n_experts:
            pairs.append((moe_mod.moe_pspec(cfg, tp),
                          ref_moe.moe_pspec(rcfg, tp)))
        if cfg.ssm_state:
            pairs.append((ssm.mamba_pspec(cfg, tp),
                          ref_ssm.mamba_pspec(rcfg, tp)))
        for got, want in pairs:
            assert list(_flat(got)) == list(_flat(want)), (cfg.name, tp)
            n += 1
    assert n > 300


def test_cache_and_state_pspecs():
    for axes in ("data", ("pod", "data")):
        for flag in (False, True):
            assert list(_flat(ssm.ssm_state_pspec(axes, flag))) == \
                list(_flat(ref_ssm.ssm_state_pspec(axes, flag)))
            for kv_ok in (False, True):
                for quantized in (False, True):
                    assert list(_flat(attn.cache_pspec(
                        axes, flag, kv_ok, quantized))) == list(_flat(
                            ref_attn.cache_pspec(axes, flag, kv_ok,
                                                 quantized)))


def test_index_is_row_major_over_axes():
    """A dimension sharded over several axes splits row-major, as
    ``PartitionSpec(("pod", "data"))`` does: pod 1, data 0 of (2, 3) is
    block 3 of 6."""
    sh = Sharding(PortMesh((2, 3, 2), (1, 0, 1), ("pod", "data", "model")),
                  ("pod", "data"))
    assert (sh.tp, sh.rank, sh.n_data, sh.data_rank) == (2, 1, 6, 3)
    assert sh.index(layers.P(("pod", "data"), None, "model"),
                    (12, 5, 8)) == (slice(6, 8), slice(0, 5), slice(4, 8))
    with pytest.raises(ValueError, match="does not split"):
        sh.index(layers.P("model"), (7,))


@pytest.mark.parametrize("case,tp,layout", [
    # 4 q / 2 kv at tp 4: kv replicated, each rank one q head and its
    # kv head (ranks 0, 1 share kv head 0)
    ({}, 4, dict(partial=False, kv_sharded=False, g=1, sel=None)),
    # 6 q heads at tp 4: q heads do not divide -> partial-sum TP
    ({"n_heads": 6}, 4, dict(partial=True, kv_sharded=False)),
    # 6 q / 3 kv at tp 2: rank 0's q heads 0-2 read kv heads 0, 0, 1
    ({"n_heads": 6, "n_kv_heads": 3}, 2,
     dict(partial=False, kv_sharded=False, g=1, sel=(0, 0, 1))),
    ({}, 2, dict(partial=False, kv_sharded=True, g=2, sel=None)),
])
def test_attention_fallbacks_reached(case, tp, layout):
    cfg = dataclasses.replace(get("qwen3-0.6b").reduced(), **case)
    lay = attn.attn_layout(cfg, Sharding(PortMesh((1, tp), (0, 0))))
    for k, v in layout.items():
        assert getattr(lay, k) == v, (k, lay)


def test_moe_and_mlp_fallbacks_reached():
    """6 experts at tp 4 split each expert's d_ff; d_ff 130 at tp 4 swaps
    the MLP's layout (both as ``tests/test_torch_serve_mesh.py`` serves
    them)."""
    cfg = dataclasses.replace(get("mixtral-8x7b").reduced(), n_experts=6)
    assert _t(moe_mod.moe_pspec(cfg, 4)["wi"]) == (None, None, "model")
    assert _t(layers.mlp_pspec("gelu", 130, 4)["wi"]) == ("model", None)


def test_batch_one_over_data_shards_names_item_13c():
    """A batch of 1 over two data shards is sequence-parallel (the
    reference's ``shard_seq``, item 13c): the row is replicated and a
    cache's slots split over the shards; rows and slots that do not
    divide raise."""
    sh = Sharding(PortMesh((2, 1), (1, 0)))
    assert sh.local_rows(4) == 2
    assert sh.local_rows(1) == 1 and sh.seq_parallel(1)
    assert not sh.seq_parallel(4) and not NO_MESH.seq_parallel(1)
    assert sh.split_rows(np.arange(4)[:, None]).ravel().tolist() == [2, 3]
    assert sh.split_rows(np.arange(1)[:, None]).ravel().tolist() == [0]
    assert sh.seq_slots(2080) == slice(1040, 2080)
    with pytest.raises(ValueError, match="does not split"):
        sh.local_rows(3)
    with pytest.raises(ValueError, match="does not split"):
        sh.seq_slots(7)


def test_default_server_issues_no_collective(monkeypatch):
    """No mesh, ``model_axis=1``: generation calls no collective
    (``torch.distributed``'s, through which every one the port issues
    goes, raise here)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.serve import Server, request_batch

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was issued")
    for name in ("all_reduce", "all_gather", "broadcast",
                 "all_to_all_single", "all_gather_object"):
        monkeypatch.setattr(dist, name, refuse)
    cfg = get("qwen3-0.6b").reduced()
    srv = Server(cfg, 2, 8, 3, device="cpu")
    srv.init_params(0)
    out = srv.generate(request_batch(cfg, 2, 8, np.random.default_rng(0)))
    assert out["tokens"].shape == (2, 3)


@pytest.mark.parametrize("batch", [1, 8])
def test_step_builders_carry_their_specs(batch):
    """``make_prefill_objects`` / ``make_decode_objects`` return the specs
    where the reference returns shardings: the model's parameter specs,
    the batch's, and for the decode the caches' (a batch of 1 shards the
    cache's sequence, as the reference's ``shard_seq``)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import (make_decode_objects,
                                          make_prefill_objects)
    cfg = get("qwen3-0.6b")
    shape = ShapeSpec("s", 64, batch, "decode")
    mesh = PortMesh((1, 2), (0, 1))
    model, step, _ = make_decode_objects(cfg, shape, device="meta",
                                         mesh=mesh)
    assert step.specs["params"] == model.param_pspecs()
    assert step.specs["caches"] == model.cache_pspecs(batch == 1)
    assert step.specs["batch"] == batch_pspecs(cfg, shape, ("data",))
    pshape = ShapeSpec("p", 64, batch, "prefill")
    model, step, _ = make_prefill_objects(cfg, pshape, device="meta",
                                          mesh=mesh)
    assert set(step.specs) == {"params", "batch"}
    assert step.specs["batch"]["tokens"] == (
        (None, None) if batch == 1 else ("data", None))
