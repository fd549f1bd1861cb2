"""BENCHMARK.json and the files it names: keys, names and units in the
allowed characters, every named file present, every per-layer metric with
its reader, and the configurations' cuts listed; a configuration's
reference module and its program's fields."""

import json
import re

import pytest

from portbench import common, traffic

B = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads",
          "num_experts_per_tok", "head_dim")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"] and B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_and_names(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        assert set(e) <= KEYS[kind] and set(e) >= KEYS[kind] - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics_sources_bounds_and_cells():
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in cells:
        assert sum(1 for m in B["end_to_end"] if w in m.get("workloads", [w])) >= 2
        assert any(w in m["workloads"] for m in B["per_layer"])
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
        assert (common.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_their_files():
    pairs = set()
    configs = {c["name"]: c for c in B["configs"]}
    for w in B["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic.load(w["traffic"])
        lim = common.limits(w["name"])
        assert lim and all(v > 0 for v in lim.values())
    assert {w["config"] for w in B["workloads"]} == set(configs)


@pytest.mark.parametrize("entry", B["configs"], ids=lambda c: c["name"])
def test_configuration_files_list_their_cuts(entry):
    assert entry["file"].startswith("portbench/configs/")
    conf = common.load_json(entry["file"])
    assert conf["name"] == entry["name"]
    assert entry["source"].startswith("https://") and conf["source"] == entry["source"]
    assert sorted(conf["reduced_from"]) == sorted(entry["reduced"])
    for key, published in conf["reduced_from"].items():
        assert conf[key] != published and NAME.match(key)
        assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
    assert (common.ROOT / conf["reference"]).exists()


def test_the_file_fits_its_size_limit():
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert json.loads((common.ROOT / "BENCHMARK.json").read_text()) == B


def _model_configs():
    """The program's fields of each accepted configuration, written out as
    the mapping gave them before a configuration could bring its own."""
    from repro_torch.models.config import ModelConfig, MoEConfig

    intern = dict(family="dense", d_model=6144, num_heads=48, num_kv_heads=8, d_ff=16384,
                  vocab_size=92544, head_dim=None, mlp="swiglu", rope_theta=1000000.0,
                  norm_eps=1e-05, tie_embeddings=False, moe=None, dtype="bfloat16")
    return {
        "internlm2-20b": ModelConfig(name="internlm2-20b", num_layers=48,
                                     param_dtype="bfloat16", remat="none", **intern),
        "internlm2-20b-4L": ModelConfig(name="internlm2-20b-4L", num_layers=4,
                                        param_dtype="float32", remat="full", **intern),
        "olmoe-1b-7b-4L": ModelConfig(
            name="olmoe-1b-7b-4L", family="moe", num_layers=4, d_model=2048, num_heads=16,
            num_kv_heads=16, d_ff=1024, vocab_size=50304, head_dim=None, mlp="swiglu",
            rope_theta=10000.0, norm_eps=1e-05, tie_embeddings=False,
            moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024, capacity_factor=1.25,
                          expert_parallel=True),
            dtype="bfloat16", param_dtype="float32", remat="full"),
    }


@pytest.mark.parametrize("name", ["internlm2-20b", "internlm2-20b-4L", "olmoe-1b-7b-4L"])
def test_the_accepted_configurations_read_what_they_read(name):
    from portbench import program

    conf = common.load_json(f"portbench/configs/{name}.json")
    assert "program" not in conf
    assert program.model_config(conf) == _model_configs()[name]
    ref = common.reference(conf)
    assert ref.__file__ == str(common.HERE / "reference" / "decoder.py")
    assert common.reference(conf) is ref


def test_a_program_object_is_applied_over_the_mapping():
    import dataclasses

    from portbench import program

    conf = common.load_json("portbench/configs/olmoe-1b-7b-4L.json")
    conf["program"] = {"mlp": "relu2", "remat": "none",
                       "moe": {"num_shared_experts": 1, "capacity_factor": 8.0},
                       "ssm": {"state_dim": 128}}
    got = program.model_config(conf)
    want = _model_configs()["olmoe-1b-7b-4L"]
    assert got.mlp == "relu2" and got.remat == "none" and got.ssm.state_dim == 128
    assert got.ssm.head_dim == 64                         # the dataclass's own default
    assert got.moe == dataclasses.replace(want.moe, num_shared_experts=1, capacity_factor=8.0)
    assert dataclasses.replace(got, mlp="swiglu", remat="full", moe=want.moe,
                               ssm=None) == want


@pytest.mark.parametrize("given,named", [
    ({"remat_grup": 2}, "program.remat_grup"),
    ({"moe": {"capacity_factr": 8.0}}, "program.moe.capacity_factr"),
    ({"xlstm": {"chunk": 64}}, "program.xlstm.chunk"),
], ids=["top level", "moe", "xlstm"])
def test_an_unknown_program_key_is_named(given, named):
    from portbench import program

    conf = common.load_json("portbench/configs/olmoe-1b-7b-4L.json")
    conf["program"] = given
    with pytest.raises(ValueError, match=re.escape(named)):
        program.model_config(conf)


def test_a_reference_without_a_function_of_the_contract_is_refused(tmp_path):
    src = (common.HERE / "reference" / "decoder.py").read_text()
    path = tmp_path / "no_train.py"
    path.write_text(src + "\n\ndel train, relative_diffs\n")
    with pytest.raises(ImportError, match="relative_diffs") as err:
        common.reference({"reference": str(path)})
    assert "train" in str(err.value)
