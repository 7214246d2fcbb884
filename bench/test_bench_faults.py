"""A run of a small cell on the CPU, the chip's look skipped, with the
served path broken underneath: the output check has to come out false for
each fault a serving cell on one chip can have, and true without one. (The
exchange between chips is not a fault of these one-chip cells.)"""
import numpy as np
import pytest
import torch

from bench import harness
from bench.testing import small_cell
from repro_torch.launch.serve import Server
from repro_torch.models import hybrid

SEED = 2**31 + 3


def _run(workload):
    return harness.run_cell(small_cell(workload), SEED, 0.2, False,
                            device="cpu")


def _state_unchanged(monkeypatch):
    def step(self, x, conv, ssm):
        y, _ = hybrid.mamba_decode(self.mamba,
                                   hybrid.rms_norm(x, self.ln,
                                                   self.cfg.norm_eps),
                                   self.cfg, conv, ssm, self.msh)
        return x + y
    monkeypatch.setattr(hybrid.MambaBlock, "step", step)


def _half_batch(monkeypatch):
    prefill = hybrid.MambaLM.prefill

    def half(self, batch, cache_len=None):
        tok = batch["tokens"]
        n = tok.shape[0] // 2 or 1
        logits, (conv, ssm) = prefill(self, {"tokens": tok[:n]}, cache_len)
        rest = tok.shape[0] - n
        logits = torch.cat([logits, logits.mean(0, keepdim=True)
                            .expand(rest, *logits.shape[1:])])
        conv = torch.cat([conv, conv[:, :1].expand(-1, rest, -1, -1)], 1)
        ssm = torch.cat([ssm, ssm[:, :1].expand(-1, rest, -1, -1, -1)], 1)
        return logits, (conv, ssm)
    monkeypatch.setattr(hybrid.MambaLM, "prefill", half)


def _logit_altered(monkeypatch):
    logits = hybrid.MambaLM.logits

    def altered(self, h):
        out = logits(self, h).clone()
        out[0, -1, 7] = out[0, -1].max() + 10.0
        return out
    monkeypatch.setattr(hybrid.MambaLM, "logits", altered)


def _token_altered(monkeypatch):
    generate = Server.generate

    def altered(self, batch):
        out = generate(self, batch)
        tok = out["tokens"].copy()
        tok[:, -1] = (tok[:, -1] + 1) % self.cfg.vocab
        return {**out, "tokens": tok}
    monkeypatch.setattr(Server, "generate", altered)


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill-2k",
                                      "mamba2-2.7b.decode-b256"])
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _logit_altered, _token_altered])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run("mamba2-2.7b.prefill-2k")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill-2k",
                                      "mamba2-2.7b.decode-b256"])
def test_control_is_not_correct(workload):
    """The reference with float8 matmuls in the program's place, over the
    program's prompts and tokens, fails the cell's limits, where the
    program in bfloat16 keeps them (24 blocks of width 256: the error grows
    with depth)."""
    c = small_cell(workload, d=256, layers=24, dtype="bfloat16")
    b = harness.Bench(c, "cpu")
    b.load(SEED)
    calls = [b.call(SEED, k) for k in range(2)]
    nums = harness.judge(c.conf, calls, b.weights(SEED), "cpu",
                         control=True)
    assert any(nums["control_" + n] > c.limits[n]
               for n in ("logit_err", "logit_dev"))
    assert all(nums[n] <= c.limits[n] for n in c.limits)
    assert np.isfinite(list(nums.values())).all()
