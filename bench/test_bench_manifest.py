"""The manifest and the files it names: every cell, configuration, traffic
mix, limit file and metric reader is found by name and keeps to the
benchmark's contract."""
import json
import re

import pytest

from bench import harness

MAN = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    full = 2 + 14 * 24
    assert full * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", MAN["workloads"],
                         ids=lambda w: w["name"])
def test_cell_found_by_name(workload):
    c = harness.cell(workload["name"])
    assert c.chips == workload["chips"] and c.chips in (1, 4)
    assert c.traffic.batch > 0
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.limits.get("token_mismatch", 0) == 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    ref = harness.reference(c.conf)
    assert callable(ref.logits_at) and callable(ref.flops)
    run = harness.launcher(c)
    assert callable(run) and (c.chips > 1 or run is harness.run_cell)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric))


#: per reference: the served program's fields that the configuration file's
#: own keys fix
PORT_FIELDS = {
    "mamba2": lambda conf: {
        "n_layers": conf["n_layer"], "d_model": conf["d_model"],
        "vocab": conf["vocab_size"],
        "ssm_state": conf["mamba2"]["d_state"],
        "ssm_head_dim": conf["mamba2"]["headdim"],
        "ssm_expand": conf["mamba2"]["expand"],
        "ssm_conv": conf["mamba2"]["d_conv"],
        "ssm_chunk": conf["mamba2"]["chunk_size"],
        "norm_eps": conf["norm_epsilon"], "dtype": conf["dtype"]},
}


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_runs(config):
    """Every key changed from the source is listed, and where the
    configuration's reference is known here, the port's fields say what the
    file's own keys say."""
    conf = json.loads((harness.ROOT / config["file"]).read_text())
    assert set(config["reduced"]) == set(conf["reduced_from_source"])
    fields = PORT_FIELDS.get(conf["reference"])
    if fields is not None:
        want = fields(conf)
        assert {k: conf["port"]["fields"][k] for k in want} == want
