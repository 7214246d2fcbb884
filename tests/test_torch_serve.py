"""The port's serving loop against the reference ``Server``, on the CPU,
and its command line."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.launch.serve import Server as RefServer
from repro_torch.configs import get
from repro_torch.launch import serve
from repro_torch.models import params_from_reference


def test_generate_matches_reference_server():
    """Reduced qwen3, batch 2, prompt 16, 6 new tokens, no EOS: the port
    loaded with the reference Server's ``init_params(0)`` emits the same
    greedy tokens."""
    cfg, rcfg = get("qwen3-0.6b").reduced(), ref_get("qwen3-0.6b").reduced()
    ref_srv = RefServer(rcfg, batch=2, prompt_len=16, max_new=6, eos_id=-1)
    tree = jax.tree.map(np.asarray, ref_srv.init_params(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(2, cfg.vocab, (2, 16)).astype(np.int32)}
    want = ref_srv.generate(tree, batch)

    srv = serve.Server(cfg, batch=2, prompt_len=16, max_new=6, eos_id=-1,
                       device="cpu")
    srv.model.load_state_dict(params_from_reference(cfg, tree))
    got = srv.generate(batch)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens_generated"] == want["tokens_generated"] == 12
    assert got["tokens"].dtype == np.int32


def test_generate_stops_when_every_slot_emitted_eos():
    cfg = get("qwen3-0.6b").reduced()
    srv = serve.Server(cfg, batch=2, prompt_len=8, max_new=6, device="cpu")
    srv.init_params(1)
    batch = {"tokens": np.full((2, 8), 3, np.int32)}
    first = srv.generate(batch)["tokens"]
    srv.eos = int(first[0, 1])          # both rows are alike: stop at step 2
    out = srv.generate(batch)
    assert out["tokens"].shape == (2, 2)
    np.testing.assert_array_equal(out["tokens"], first[:, :2])


@pytest.mark.parametrize("extra", [[], ["--plan", "--pop", "8", "--iters",
                                        "5"]])
def test_cli_runs_on_the_cpu(extra, capsys):
    serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--max-new", "3",
                *extra])
    out = capsys.readouterr().out
    assert "[serve] qwen3-0.6b-smoke on cpu" in out
    assert ("PSO-GA fleet placement for decode_32k" in out) == bool(extra)


def test_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Server(get("qwen3-0.6b").reduced(), 1, 4, 2)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_generate_ssm_and_hybrid(arch):
    """Reduced mamba2 and zamba2 through the same ``Server``: a 21-token
    prompt (a ragged last chunk), 5 new tokens, no EOS; token shapes and
    range, and the same tokens from a second call (greedy, and the caches
    of the first call do not leak into the second)."""
    cfg = get(arch).reduced()
    srv = serve.Server(cfg, batch=2, prompt_len=21, max_new=5, eos_id=-1,
                       device="cpu")
    srv.init_params(3)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(2, cfg.vocab, (2, 21)).astype(np.int32)}
    first = srv.generate(batch)
    again = srv.generate(batch)
    toks = first["tokens"]
    assert toks.shape == (2, 5) and first["tokens_generated"] == 10
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    np.testing.assert_array_equal(again["tokens"], toks)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_cli_serves_ssm_and_hybrid_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--max-new", "3"])
    assert f"[serve] {arch}-smoke on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x7b",
                                  "internvl2-2b", "whisper-medium"])
def test_cli_serves_the_other_families_on_the_cpu(arch, capsys):
    """The reference ``main``'s batch for each family: gemma3's local:global
    groups (a 40-token prompt past the reduced 32-token window), mixtral's
    experts, internvl2's 8 vision embeddings ahead of 32 tokens, whisper's
    40 frames and 5 decoder tokens."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "40", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-smoke on cpu" in out
    assert "decode 6 tokens" in out
