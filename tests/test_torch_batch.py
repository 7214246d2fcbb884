"""The port's batched fleet solver: bucket packing against the reference,
and a batched solve against the port's sequential solves, gene for
gene."""
import numpy as np
import torch
from test_torch_parity import CPU, to_port

import repro.core as ref
import repro_torch.core as port
from repro_torch.core.batch import SYNC_EVERY

torch.set_num_threads(1)


def _fleet(lib):
    """Mixed fleet: three bucket shapes, two problems sharing one."""
    env = lib.paper_environment()
    out = []
    for net, dev, ratio in (("alexnet", 0, 2.0), ("googlenet", 1, 3.0),
                            ("vgg19", 2, 1.5), ("alexnet", 3, 1.2)):
        dag = lib.zoo.build(net, pin_server=dev)
        h, _ = lib.heft_makespan(dag, env)
        out.append((dag.with_deadline(np.array([ratio * h])), env))
    return out


def test_pack_fleet_matches_reference():
    fr = ref.pack_fleet(_fleet(ref))
    fp = port.pack_fleet(_fleet(port), device=CPU)
    assert fp.n_problems == fr.n_problems and fp.max_apps == fr.max_apps
    assert len(fp.buckets) == len(fr.buckets) == 3
    for bp, br in zip(fp.buckets, fr.buckets):
        assert (bp.max_p, bp.max_S) == (br.max_p, br.max_S)
        np.testing.assert_array_equal(bp.idx, br.idx)
        conv = to_port(br.ppb)
        for field in port.PaddedProblem._fields:
            assert torch.equal(getattr(bp.ppb, field), getattr(conv, field))
    packed = port.pack_problems(_fleet(port), device=CPU)
    assert packed.compute.shape == (4, port.bucket_size(83))
    assert port.bucket_size(20, floor=4) == 32


def test_batched_equals_sequential_gene_for_gene():
    """Every problem of a batched solve (per-problem seeds, shared buckets,
    per-problem freezing) equals its own sequential solve exactly."""
    cfg = port.PSOGAConfig(pop_size=10, max_iters=30, stall_iters=5)
    seeds = [4, 9, 4, 1]
    batched = port.run_pso_ga_batch(_fleet(port), cfg, seed=seeds,
                                    device=CPU)
    iters = set()
    for (dag, env), seed, got in zip(_fleet(port), seeds, batched):
        want = port.run_pso_ga(dag, env, cfg, seed=seed, device=CPU)
        np.testing.assert_array_equal(got.best_x, want.best_x)
        assert got.best_fitness == want.best_fitness
        assert got.best_cost == want.best_cost
        assert (got.feasible, got.iterations) == (want.feasible,
                                                  want.iterations)
        iters.add(got.iterations)
    # freezing at different iterations, not all on a sync boundary
    assert len(iters) > 1 and any(i % SYNC_EVERY for i in iters)

