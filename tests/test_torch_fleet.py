"""PyTorch port, the heterogeneous fleet planner (engine/fleet.py:
plan_fleet, partition_devices, check_fleet_fits, device_memory_bytes) and
its caller adapters/factory._plan_engine_fleet, against the JAX package's.

Every case of tests/test_fleet.py goes through both planners on deep
copies of the same configs: the device groups written, the quant flips
and their `_quant_auto_degraded` marks, the warnings and the error text
must be identical. On the CPU the port plans one device with no memory
limit (as the JAX package's CPU backend reports none); groups of several
devices are refused by the engine until Queue 1 slice 6. The engines
carry `_quant_auto_degraded`, `long_threshold` and `long_scheme` through
from_config, and three engines of different models serve concurrently,
each giving its tokens alone."""

import copy
import warnings

import pytest
import torch

GIB = 1 << 30
TRIO = ("gemma-7b-it", "llama-3-8b-instruct", "mistral-7b-instruct")
# An H100 80GB HBM3 reports 81,559 MiB of total memory.
H100_BUDGET = int(81559 * (1 << 20) * 0.75)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan_both(cfgs, **kw):
    """((configs, warnings, error) of JAX's plan_fleet, the same of the
    port's on the CPU), each on its own deep copy of `cfgs`."""
    from theroundtaible_tpu.engine.fleet import plan_fleet as jax_plan
    from theroundtaible_tpu_torch.engine.fleet import plan_fleet

    def run(plan, **extra):
        mine = copy.deepcopy(cfgs)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                plan(mine, **kw, **extra)
                err = None
            except ValueError as e:
                err = str(e)
        said = [str(w.message) for w in caught
                if "Fleet" in str(w.message)]
        return mine, said, err

    return run(jax_plan), run(plan_fleet, device="cpu")


def _cfgs(models, **over):
    return [{"model": m, **over} for m in models]


TINY3 = ("tiny-gemma", "tiny-llama", "tiny-mistral")
SMALL = dict(max_seq_len=2048, num_slots=2)
PLAN_CASES = {
    "heterogeneous_disjoint": (_cfgs(TINY3), dict(n_devices=8)),
    "same_model_shares_group": (
        _cfgs(("tiny-gemma", "tiny-gemma", "tiny-llama")),
        dict(n_devices=8)),
    "homogeneous_untouched": (_cfgs(("tiny-gemma", "tiny-gemma")),
                              dict(n_devices=8)),
    "explicit_layout_wins": (
        [{"model": "tiny-gemma", "mesh": {"model": 2}},
         {"model": "tiny-llama"}], dict(n_devices=8)),
    "explicit_devices_win": (
        [{"model": "tiny-gemma", "devices": [0]}, {"model": "tiny-llama"}],
        dict(n_devices=1)),
    "overcommit_int8": (
        _cfgs(("mistral-7b-instruct", "llama-3-8b-instruct"), **SMALL),
        dict(n_devices=1, budget_bytes=20 * GIB)),
    "overcommit_int4": (
        _cfgs(("mistral-7b-instruct", "llama-3-8b-instruct"), **SMALL),
        dict(n_devices=1, budget_bytes=12 * GIB)),
    "explicit_int8_never_reflipped": (
        _cfgs(("mistral-7b-instruct", "llama-3-8b-instruct"),
              quant="int8", **SMALL),
        dict(n_devices=1, budget_bytes=12 * GIB)),
    "impossible_fit": (
        _cfgs(("mistral-7b-instruct", "llama-3-8b-instruct"),
              quant="int8", **SMALL),
        dict(n_devices=1, budget_bytes=4 * GIB)),
    "fits_untouched": (
        _cfgs(("gemma-2b-it", "llama-3.2-1b-instruct"), **SMALL),
        dict(n_devices=8, budget_bytes=16 * GIB)),
    "v5e_trio_fits": (
        _cfgs(("llama-3.2-3b-instruct", "gemma-2b-it",
               "llama-3.2-1b-instruct"), quant="int8", **SMALL),
        dict(n_devices=1, budget_bytes=int(16 * GIB * 0.75))),
    "v5e_trio_rejected": (
        _cfgs(("mistral-7b-instruct", "gemma-2b-it",
               "llama-3.2-1b-instruct"), quant="int8", **SMALL),
        dict(n_devices=1, budget_bytes=int(16 * GIB * 0.75))),
    "no_budget_no_check": (
        _cfgs(("mistral-7b-instruct", "llama-3-8b-instruct")),
        dict(n_devices=1, budget_bytes=None)),
    "baseline_trio_8_devices_bf16": (
        _cfgs(TRIO, **SMALL),
        dict(n_devices=8, budget_bytes=int(16 * GIB * 0.75))),
    "baseline_trio_4_devices_int8": (
        _cfgs(TRIO, **SMALL),
        dict(n_devices=4, budget_bytes=int(16 * GIB * 0.75))),
    "baseline_trio_pinned_f32_raises": (
        _cfgs(TRIO, dtype="float32", **SMALL),
        dict(n_devices=4, budget_bytes=int(16 * GIB * 0.75))),
    # chip_smoke's fleet_trio: the trio at the script's engine shape on
    # one H100's plannable memory
    "baseline_trio_one_h100": (
        _cfgs(TRIO, num_slots=8, max_seq_len=8192, kv_layout="paged"),
        dict(n_devices=1, budget_bytes=H100_BUDGET)),
    "distinct_engines_charged_each": (
        [{"model": "llama-3-8b-instruct", "max_seq_len": 2048},
         {"model": "llama-3-8b-instruct", "max_seq_len": 8192},
         {"model": "mistral-7b-instruct", "max_seq_len": 2048}],
        dict(n_devices=1, budget_bytes=30 * GIB)),
    "unknown_model_tolerated": (
        _cfgs(("no-such-model", "tiny-llama")),
        dict(n_devices=2, budget_bytes=GIB)),
    "paged_kv_quant_and_lora": (
        [{"model": "llama-3-8b-instruct", "kv_layout": "paged",
          "num_pages": 256, "kv_quant": "int8"},
         {"model": "mistral-7b-instruct", "lora": {"rank": 8}}],
        dict(n_devices=1, budget_bytes=24 * GIB)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_fleet_equals_jax(case):
    cfgs, kw = PLAN_CASES[case]
    jax_out, port_out = _plan_both(cfgs, **kw)
    assert port_out == jax_out


def test_the_predictions_of_the_card_run():
    """What chip_smoke's fleet_trio expects from the planner on one H100:
    Gemma-7B degraded twice, to int4, the other two kept bf16, every group
    [0]."""
    _jax, (cfgs, said, err) = _plan_both(
        *PLAN_CASES["baseline_trio_one_h100"][:1],
        **PLAN_CASES["baseline_trio_one_h100"][1])
    assert err is None and len(said) == 2
    assert [c.get("quant") for c in cfgs] == ["int4", None, None]
    assert cfgs[0]["_quant_auto_degraded"] is True
    assert all(c["devices"] == [0] for c in cfgs)


PARTITION_CASES = [([100, 100, 100], 8), ([1000, 10], 8), ([1, 1, 1], 2),
                   ([7], 8), ([], 8), ([3, 2, 1], 1), ([5, 1], 4),
                   ([9, 3, 3], 16)]


@pytest.mark.parametrize("weights,n", PARTITION_CASES)
def test_partition_devices_equals_jax(weights, n):
    from theroundtaible_tpu.engine.fleet import partition_devices as jax_p
    from theroundtaible_tpu_torch.engine.fleet import partition_devices
    assert partition_devices(weights, n) == jax_p(weights, n)


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-qwen", "tiny-mixtral",
                                   "gemma-2b-it", "llama-3-8b-instruct",
                                   "gemma-7b-it", "mistral-7b-instruct"])
def test_estimates_equal_jax(model):
    from theroundtaible_tpu.engine import fleet as jfleet
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine import fleet
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    assert fleet.estimate_param_count(get_model_config(model)) == \
        jfleet.estimate_param_count(jax_config(model))
    for cfg in ({"model": model}, {"model": model, "quant": "int8"},
                {"model": model, "quant": "int4", "num_slots": 8,
                 "kv_layout": "paged"}):
        assert fleet.estimate_engine_hbm_bytes(cfg) == \
            jfleet.estimate_engine_hbm_bytes(cfg)


def test_device_memory_and_count_on_the_cpu():
    """No limit on the CPU (None: no check) and one device; a CUDA device
    without a card raises instead of guessing."""
    from theroundtaible_tpu_torch.engine import fleet
    assert fleet.device_memory_bytes("cpu") is None
    assert fleet.device_count("cpu") == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fleet.device_memory_bytes()
        with pytest.raises(RuntimeError):
            fleet.device_count()


def test_check_fleet_fits_equals_jax_on_shared_devices():
    """check_fleet_fits alone on groups that share a device (models >
    devices): the accumulation, the flip order and the marks."""
    from theroundtaible_tpu.engine.fleet import check_fleet_fits as jax_fit
    from theroundtaible_tpu_torch.engine.fleet import check_fleet_fits
    base = {m: [{"model": m, "max_seq_len": 4096}] for m in TRIO}
    groups = [[0], [1], [0]]
    outs = []
    for fit in (jax_fit, check_fleet_fits):
        ids = copy.deepcopy(base)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fit(ids, groups, 24 * GIB)
        outs.append((ids, [str(w.message) for w in caught]))
    assert outs[0] == outs[1]


# --- the engines ---

DESCRIBE_CASES = {
    "plain": {},
    "int8_auto_degraded": {"quant": "int8", "_quant_auto_degraded": True},
    "int4_auto_degraded": {"quant": "int4", "_quant_auto_degraded": True},
    "long_keys": {"seq_parallel": 2, "long_threshold": 64,
                  "long_scheme": "ulysses"},
}


@pytest.mark.parametrize("case", list(DESCRIBE_CASES))
def test_from_config_carries_jax_keys(case):
    """The same config dict through both packages' from_config:
    describe()'s quant (e.g. "int8 (auto-degraded)") and shape keys agree,
    and long_threshold / long_scheme reach the engine."""
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    config = {"model": "tiny-llama", "max_seq_len": 128, "num_slots": 2,
              "mesh": {"data": 1, "model": 1}, **DESCRIBE_CASES[case]}
    jeng = JaxEngine.from_config(dict(config))
    teng = InferenceEngine.from_config(dict(config), device="cpu")
    dj, dt = jeng.describe(), teng.describe()
    for key in ("model", "params", "max_seq_len", "num_slots", "kv_layout",
                "quant", "mesh"):
        assert dt[key] == dj[key], key
    assert teng.long_threshold == jeng.long_threshold
    if case == "long_keys":
        assert teng.long_scheme == "ulysses"
        assert teng.long_threshold == 64


def test_several_devices_wait_for_slice_6():
    """A group of several devices (a machine with several cards) is the
    multi-device option still to port: the engine names item 7e-ii. One
    index on the CPU is its one device."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    config = {"model": "tiny-llama", "max_seq_len": 128}
    with pytest.raises(NotImplementedError, match="7e-ii"):
        InferenceEngine.from_config({**config, "devices": [0, 1]},
                                    device="cpu")
    eng = InferenceEngine.from_config({**config, "devices": [0]},
                                      device="cpu")
    assert str(eng.device) == "cpu"


def _knights_config(adapter_config):
    from theroundtaible_tpu_torch.core.types import (KnightConfig,
                                                     RoundtableConfig,
                                                     RulesConfig)
    return RoundtableConfig(
        version="1.0", project="p", language="en",
        knights=[KnightConfig(name=f"K{i}", adapter=a, priority=i + 1)
                 for i, a in enumerate(adapter_config)],
        rules=RulesConfig(max_rounds=1), chronicle="chronicle.md",
        adapter_config=adapter_config)


def test_factory_plans_and_seats_without_a_notice():
    """initialize_adapters plans two engine knights of different models
    (an unconfigured id gets its dict inserted - the default model,
    tiny-gemma - as JAX's factory does) and
    seats both with no notice; each engine is built on its planned
    device."""
    from theroundtaible_tpu_torch.adapters.factory import initialize_adapters
    from theroundtaible_tpu_torch.engine import reset_engines
    reset_engines()
    try:
        adapter_config = {"torch-llm-g": {"model": "tiny-llama",
                                          "max_seq_len": 128},
                          "torch-llm": None}
        config = _knights_config(adapter_config)
        config.adapter_config.pop("torch-llm")
        events = []
        adapters = initialize_adapters(
            config, lambda kind, msg: events.append((kind, msg)),
            device="cpu")
        assert set(adapters) == {"torch-llm-g", "torch-llm"}
        assert not [m for kind, m in events if kind == "unavailable"]
        assert config.adapter_config["torch-llm"] == {"devices": [0]}
        assert config.adapter_config["torch-llm-g"]["devices"] == [0]
        eng = adapters["torch-llm-g"]._get_engine()
        assert eng.describe()["devices"] == ["cpu"]
    finally:
        reset_engines()


def test_factory_notice_on_failure_equals_jax(monkeypatch):
    """A planner failure reaches the operator as JAX's notice, word for
    word (the same error raised by both planners), and a real one: a trio
    pinned to int8 on a 1 GiB card."""
    from theroundtaible_tpu.adapters import factory as jfactory
    from theroundtaible_tpu.core.types import (KnightConfig as JK,
                                               RoundtableConfig as JR,
                                               RulesConfig as JRules)
    from theroundtaible_tpu.engine import fleet as jfleet
    from theroundtaible_tpu_torch.adapters import factory
    from theroundtaible_tpu_torch.engine import fleet

    def boom(cfgs, **kw):
        raise ValueError("Fleet does not fit: boom")

    monkeypatch.setattr(jfleet, "plan_fleet", boom)
    monkeypatch.setattr(fleet, "plan_fleet", boom)
    heard = []
    ids = {"tpu-llm-a": {"model": "tiny-gemma"},
           "tpu-llm-b": {"model": "tiny-llama"}}
    jconfig = JR(version="1.0", project="p", language="en",
                 knights=[JK(name=f"K{i}", adapter=a, priority=i + 1)
                          for i, a in enumerate(ids)],
                 rules=JRules(max_rounds=1), chronicle="chronicle.md",
                 adapter_config=copy.deepcopy(ids))
    jfactory._plan_tpu_fleet(jconfig, lambda k, m: heard.append((k, m)))
    factory._plan_engine_fleet(_knights_config(copy.deepcopy(ids)),
                               lambda k, m: heard.append((k, m)), "cpu")
    assert len(heard) == 2 and heard[0] == heard[1]
    assert heard[0][0] == "unavailable"
    monkeypatch.undo()
    monkeypatch.setattr(fleet, "device_memory_bytes", lambda device: GIB)
    heard.clear()
    pinned = {f"torch-llm-{i}": {"model": m, "quant": "int8"}
              for i, m in enumerate(TRIO)}
    factory._plan_engine_fleet(_knights_config(pinned),
                               lambda k, m: heard.append((k, m)), "cpu")
    assert len(heard) == 1
    assert heard[0][1].startswith("fleet planning failed (Fleet does not "
                                  "fit: device 0 needs ")
    assert heard[0][1].endswith("); engines will share the full device mesh")


def test_three_engines_serve_concurrently_as_alone():
    """Three engines of different models (the planned groups, [0] each)
    serve one concurrent round from a thread pool, each behind its own
    lock, and each knight's tokens equal its engine's run alone on a
    fresh engine."""
    from concurrent.futures import ThreadPoolExecutor
    from theroundtaible_tpu_torch.engine import get_engine, reset_engines
    from theroundtaible_tpu_torch.engine.fleet import plan_fleet
    cfgs = [{"model": m, "max_seq_len": 256, "num_slots": 2,
             "kv_layout": "paged", "page_size": 32,
             "sampling": {"temperature": 0.0, "max_new_tokens": 6}}
            for m in TINY3]
    plan_fleet(cfgs, device="cpu")
    assert [c["devices"] for c in cfgs] == [[0], [0], [0]]

    def turn(i):
        return get_engine(cfgs[i], "cpu").generate(
            f"knight {i} weighs the eastern gate", slot_name=f"k{i}")

    reset_engines()
    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            together = list(pool.map(turn, range(3)))
        reset_engines()
        alone = [turn(i) for i in range(3)]
    finally:
        reset_engines()
    assert together == alone


def test_orchestrator_runs_engine_groups_concurrently(tmp_path):
    """Two batch-capable groups and one serial knight (JAX's fan-out
    case): both groups are in flight at once, the serial knight still
    speaks."""
    import threading
    from theroundtaible_tpu_torch.adapters.fake import (FakeAdapter,
                                                        scripted_response)
    from theroundtaible_tpu_torch.core.orchestrator import run_discussion
    from theroundtaible_tpu_torch.core.types import (KnightConfig,
                                                     RoundtableConfig,
                                                     RulesConfig)
    (tmp_path / ".roundtable" / "sessions").mkdir(parents=True)
    entered = []
    barrier = threading.Barrier(2, timeout=20)

    class BatchFake(FakeAdapter):
        def supports_batched_rounds(self):
            return True

        def execute_round(self, turns, timeout_ms=0):
            entered.append(self.name)
            barrier.wait()
            return [scripted_response(9) for _ in turns]

    adapters = {"torch-llm-a": BatchFake("A"), "torch-llm-b": BatchFake("B"),
                "fake": FakeAdapter("C", script=[scripted_response(9)] * 9)}
    config = RoundtableConfig(
        version="1.0", project="p", language="en",
        knights=[KnightConfig(name="Alpha", adapter="torch-llm-a",
                              priority=1),
                 KnightConfig(name="Beta", adapter="torch-llm-b",
                              priority=2),
                 KnightConfig(name="Gamma", adapter="fake", priority=3)],
        rules=RulesConfig(max_rounds=2, consensus_threshold=9,
                          parallel_rounds=True),
        chronicle="chronicle.md", adapter_config={})
    result = run_discussion("topic", config, adapters, str(tmp_path),
                            read_source_code=False)
    assert result.consensus
    assert sorted(entered) == ["A", "B"]
    assert {e.knight for e in result.all_rounds} == {"Alpha", "Beta",
                                                     "Gamma"}
