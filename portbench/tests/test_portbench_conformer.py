"""The Conformer cell's own files: they load by name, the FLOP count
against a hand count, the seeded weights against the port's model,
``attribution.py`` on a made-up trace, the per-layer readers, and the
driver at a small size on the CPU (correct, and not under each planted
fault)."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import attribution, conformer_counts, conformer_weights, harness, run, spans

ROOT = Path(__file__).resolve().parents[2]
CELL = "train-conformer-l-b64-t1600"
NEW = ("conformer.attention_ms", "conformer.conv_ms", "conformer.subsample_ms")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config():
    return json.loads((ROOT / "portbench" / "configs" / "conformer-ctc-l-512x18.json").read_text())


SMALL = dict(d_model=64, n_heads=2, n_layers=2, conv_kernel_size=7)


def small_cell(seed: int = 2 ** 31 + 5) -> harness.Cell:
    """The cell's files with the model narrowed (d 64, 2 heads, 2 blocks,
    kernel 7) and 16 utterances of 81 frames in batches of 4; the limits
    stay the cell's."""
    arch = dict(config(), **SMALL)
    arch["port"] = [p for p in arch["port"] if p.split("=")[0] not in
                    {f"model.{k}" for k in SMALL}] + [f"model.{k}={v}" for k, v in SMALL.items()]
    tr = json.loads((ROOT / "portbench" / "traffic" / f"{CELL}.json").read_text())
    tr.update(utterances={"count": 16, "frames": 81}, batch=4, targets={"chars": [8, 16]})
    return harness.Cell(CELL, arch, tr, seed, 0.2, False, 1, torch.device("cpu"),
                        time.perf_counter())


def test_the_cell_loads_by_name():
    b, w, arch, traffic, driver = run.resolve(ROOT, CELL)
    assert (w["config"], w["chips"], traffic["driver"]) == ("conformer-ctc-l-512x18", 1,
                                                           "train_conformer")
    assert driver.name == "train_conformer.py" and driver.is_file()
    assert {c["name"]: c for c in b["configs"]}["conformer-ctc-l-512x18"]["reduced"] == []
    assert arch["d_model"] == 512 and arch["n_layers"] == 18 and arch["n_heads"] == 8
    module = run.load_module(driver, "portbench_driver_train_conformer")
    assert callable(module.run)
    for name in NEW:
        m = {x["name"]: x for x in b["per_layer"]}[name]
        assert (m["layer"], m["moves"], m["workloads"]) == ("conformer block",
                                                            "train_audio_s_per_s", [CELL])
        reader = run.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", name)
        assert reader.read({}) is None
    for name in ("train.mfu", "train.idle_share", "train.elementwise_ms", "train.host_ms"):
        assert CELL in {x["name"]: x for x in b["per_layer"]}[name]["workloads"]


def test_weights_are_the_port_models_and_count_its_parameters():
    from dsjax_torch.config import ConformerConfig, LogMelConfig
    from dsjax_torch.model.conformer import Conformer

    arch = config()
    spec = conformer_weights.leaves(arch)
    model = Conformer(29, LogMelConfig(), ConformerConfig())
    assert {n: tuple(s) for n, s, _, _ in spec} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    trained = sum(int(torch.tensor(s).prod()) for n, s, _, _ in spec if "running" not in n)
    assert trained == arch["parameters"] == sum(p.numel() for p in model.parameters())
    small = dict(arch, **SMALL)
    w = conformer_weights.make(small, 3, "cpu")
    assert torch.equal(w["encoder.layers.1.self_attn.pos_bias_u"],
                       conformer_weights.make(small, 3, "cpu")
                       ["encoder.layers.1.self_attn.pos_bias_u"])
    Conformer(29, LogMelConfig(), ConformerConfig(**SMALL)).load_state_dict(w)


def test_flops_equal_a_hand_count():
    arch = dict(config(), d_model=8, n_heads=2, n_layers=2, conv_kernel_size=3, feat_in=8,
                ff_expansion_factor=4, num_classes=5)
    # 9 frames: T1 = 5, T2 = 3; 8 mel rows: F1 = 4, F2 = 2; C = d = 8
    sub = 2 * 5 * 4 * 8 * 9 + 2 * 3 * 2 * 8 * 8 * 9 + 2 * 3 * 16 * 8
    block = (4 * 2 * 3 * 8 * 32          # two FFNs of two Linear layers
             + 4 * 2 * 3 * 64            # q, k, v, out
             + 2 * 9 * 8 + 2 * 3 * 5 * 8 + 2 * 9 * 8   # scores, offsets, v
             + 2 * 3 * 8 * 16 + 2 * 3 * 64 + 2 * 3 * 8 * 3)   # conv module
    head = 2 * 3 * 8 * 5
    positions = 2 * (2 * 5 * 64)         # 2 blocks, 5 offsets, once a batch
    assert conformer_counts.train_flops(arch, 9, 4) == 3 * (4 * (sub + 2 * block + head)
                                                           + positions)
    # the Large row at the cell's 1,601 frames: the blocks are about 70%
    p = conformer_counts.forward_parts(config(), 1601)
    assert 0.65 < p["blocks"] / (p["blocks"] + p["subsampling"] + p["head"]) < 0.75


def _made_up_trace():
    """One forward op in ``conformer.attention`` (sequence number 7)
    launching kernel 1; its backward node launching kernel 2 on the
    autograd thread; the optimizer launching kernel 3 under no span; a
    span this reading does not ask for around the whole forward."""
    def x(cat, name, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur, "args": args}

    return [
        x("user_annotation", "train.forward", 1, 0, 100),
        x("user_annotation", "conformer.attention", 1, 10, 50),
        x("cpu_op", "aten::mm", 1, 20, 20, **{"Sequence number": 7, "Fwd thread id": 0}),
        x("cuda_runtime", "cudaLaunchKernel", 1, 25, 5, correlation=101),
        x("cpu_op", "aten::add", 1, 70, 10, **{"Sequence number": 8, "Fwd thread id": 0}),
        x("cuda_runtime", "cudaLaunchKernel", 1, 72, 3, correlation=104),
        x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2, 200, 40,
          **{"Sequence number": 7, "Fwd thread id": 1}),
        x("cpu_op", "MmBackward0", 2, 201, 30, **{"Sequence number": 7, "Fwd thread id": 1}),
        x("cuda_runtime", "cudaLaunchKernel", 2, 210, 5, correlation=102),
        x("user_annotation", "train.update", 1, 300, 50),
        x("cuda_runtime", "cudaLaunchKernel", 1, 310, 5, correlation=103),
        x("kernel", "gemm_fwd", 7, 30, 1000, correlation=101),
        x("kernel", "gemm_bwd", 7, 1100, 3000, correlation=102),
        x("kernel", "adam", 7, 4200, 500, correlation=103),
        x("gpu_memcpy", "Memcpy DtoD", 8, 4800, 40, correlation=104),
    ]


def test_attribution_of_a_made_up_trace():
    got = attribution.attribute(_made_up_trace(), ("conformer.attention", "conformer.conv"))
    assert got == pytest.approx({"conformer.attention": 4000e-6, None: 540e-6})
    # asked for, the enclosing span takes what the inner one does not
    got = attribution.attribute(_made_up_trace(), ("conformer.attention", "train.forward"))
    assert got == pytest.approx({"conformer.attention": 4000e-6, "train.forward": 40e-6,
                                 None: 500e-6})


def test_readers_need_every_call_of_their_span(monkeypatch):
    layer = {"window": {"seconds": 1.0, "steps": 3, "dtype": "bfloat16", "flops": 1e12},
             "span": {"steps": 3, "seconds": 1.0, "busy_s": 0.9, "ops": {}},
             "attribution": {"seconds": {"conformer.attention": 0.6, "conformer.conv": 0.3,
                                         "conformer.subsample": 0.15},
                             "per_step": {"conformer.attention": 2, "conformer.conv": 2,
                                          "conformer.subsample": 1, "conformer.ffn": 4}}}
    calls = {"conformer.attention": 6, "conformer.conv": 6, "conformer.subsample": 3}
    monkeypatch.setattr(spans, "recorded", lambda: {k: {"calls": v, "total_s": 1.0}
                                                    for k, v in calls.items()})
    got = run.per_layer(bench(), CELL, {"train_audio_s_per_s": {}}, layer, ROOT)
    for name, ms in zip(NEW, (200.0, 100.0, 50.0)):
        assert got[name] == {"value": pytest.approx(ms), "unit": "ms"}
    calls["conformer.conv"] = 5
    got = run.per_layer(bench(), CELL, {"train_audio_s_per_s": {}}, layer, ROOT)
    assert "conformer.conv_ms" not in got and "conformer.attention_ms" in got
    monkeypatch.setattr(spans, "recorded", lambda: None)      # a port without spans
    got = run.per_layer(bench(), CELL, {"train_audio_s_per_s": {}}, layer, ROOT)
    assert not set(NEW) & set(got)


@pytest.fixture(scope="module")
def sound():
    from portbench.drivers import train_conformer

    cell = small_cell()
    return cell, train_conformer.run(cell)


def test_driver_at_a_small_size_is_correct(sound):
    from portbench import check

    cell, outcome = sound
    correct, checks = check.judge(outcome.numbers, cell.traffic["limits"])
    assert correct, checks
    assert outcome.failed == 0 and outcome.attempted >= 1
    assert outcome.end_to_end["train_audio_s_per_s"] > 0
    assert outcome.layer["window"]["flops"] > 0


@pytest.mark.parametrize("fault", ["positional", "running_stats", "whole_residual"])
def test_each_planted_fault_fails_the_limits(fault):
    from portbench import check, conformer_readings
    from portbench.drivers import train_conformer

    cell = small_cell()
    with conformer_readings.conformer_fault(fault):
        outcome = train_conformer.run(cell)
    correct, checks = check.judge(outcome.numbers, cell.traffic["limits"])
    assert not correct, checks
