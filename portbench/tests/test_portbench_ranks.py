"""Cells of several ranks on the CPU, as gloo ranks (``ranks.py``):

  * the launcher passes rank 0's output on when every rank ends well, and
    ends every rank, with a code other than 0 and within its limit, when
    one fails or one hangs;
  * the data-parallel driver (``drivers/ddp_train.py``), run as two ranks
    at a small size with the harness's look for a card skipped: in float32
    it agrees with the reference far inside the limits, a sound run is
    correct with ``rank_gap`` 0, and each fault a data-parallel cell can
    have (``faults.DDP_FAULTS``) is not correct;
  * its traced span gives ``ddp.host_wait_ms`` from the ranks' host
    collectives, and ``ddp.nccl_exposed_ms`` reads the trace's NCCL time
    that no other operation hides.
"""

import json
import os
import sys
import textwrap
import time
from pathlib import Path

import pytest

from portbench import check, harness, ranks, run

ROOT = Path(__file__).resolve().parents[2]
CELL = "ddp4-train-bilstm-b64-t1024"

STUB = """
import sys, time
import torch
import torch.distributed as dist
dist.init_process_group("gloo")
rank = dist.get_rank()
x = torch.ones(1)
dist.all_reduce(x)
if rank == 1 and sys.argv[1] == "fail":
    raise RuntimeError("rank 1 fails")
if rank == 1 and sys.argv[1] == "hang":
    time.sleep(600)
dist.all_reduce(x)
if rank == 0:
    print("the result", float(x))
print("rank", rank, "done", file=sys.stderr)
"""


def stub(tmp_path, case, timeout_s):
    path = tmp_path / "stub.py"
    path.write_text(STUB)
    t0 = time.monotonic()
    ended = ranks.launch([sys.executable, str(path), case], 2, timeout_s)
    return ended, time.monotonic() - t0


def test_launcher_passes_rank_0_on(tmp_path):
    ended, _ = stub(tmp_path, "ok", 120)
    assert ended.ok and ended.returncodes == [0, 0], ended
    assert ended.stdout[0].strip() == "the result 4.0" and ended.stdout[1] == ""
    assert "rank 1 done" in ended.stderr[1]


def _gone(ended):
    # every rank has been waited for: each has an exit code
    return all(isinstance(c, int) for c in ended.returncodes)


def test_a_rank_that_fails_ends_every_rank(tmp_path):
    ended, seconds = stub(tmp_path, "fail", 120)
    assert not ended.ok and "rank 1 exited with 1" in ended.reason
    assert ended.returncodes[1] == 1 and ended.returncodes[0] != 0   # rank 0 was killed
    assert _gone(ended) and seconds < 60
    assert "rank 1 fails" in ended.stderr[1]


def test_a_rank_that_hangs_ends_every_rank_at_the_limit(tmp_path):
    ended, seconds = stub(tmp_path, "hang", 20)
    assert not ended.ok and "still running after 20 s" in ended.reason
    assert all(c != 0 for c in ended.returncodes)
    assert _gone(ended) and 20 <= seconds < 40


DRIVER = """
import json, sys, time
sys.path.insert(0, {root!r})
from torch.profiler import ProfilerActivity, profile
from dsjax_torch.parallel import distributed
from portbench import faults, harness
from portbench.tests.small import driver, small_cell


def cpu_trace_span(fn, device):
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        fn()
        seconds = time.perf_counter() - t0
    return {{"seconds": seconds, "busy_s": 0.0, "ops": {{}}, "gaps": {{}}, "exposed": {{}}}}


harness.trace_span = cpu_trace_span
distributed.initialize("cpu")
results = {{}}
for case in ["sound", "float32", "traced", *faults.DDP_FAULTS]:
    cell = small_cell({cell!r}, seed=2 ** 31 + 11)
    if case == "float32":
        cell.traffic["port"] = [p for p in cell.traffic["port"]
                                if not p.startswith("trainer.precision")] + ["trainer.precision=32"]
    cell.trace = case == "traced"
    if case in faults.DDP_FAULTS:
        with faults.train_fault(case):
            o = driver(cell).run(cell)
    else:
        o = driver(cell).run(cell)
    if o is not None:
        results[case] = {{"numbers": o.numbers, "layer": o.layer,
                          "summary": __import__("dsjax_torch.trace").trace.summary()}}
    __import__("dsjax_torch.trace").trace.reset()
distributed.destroy()
if distributed.rank() == 0 and results:
    print(json.dumps(results, default=repr))
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("ddp") / "driver.py"
    path.write_text(DRIVER.format(root=str(ROOT), cell=CELL))
    ended = ranks.launch([sys.executable, str(path)], 2, 900,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert ended.ok, (ended.reason, ended.stderr[0][-4000:], ended.stderr[1][-4000:])
    return json.loads(ended.stdout[0].strip().splitlines()[-1])


def limits():
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{CELL}.json").read_text())
    return traffic["limits"]


def test_float32_program_agrees_with_the_reference(two_ranks):
    numbers = two_ranks["float32"]["numbers"]
    most = {"loss_gap": 1e-5, "grad_gap": 1e-3, "grad_dir_gap": 1e-4, "change_gap": 1e-2,
            "rank_gap": 0.0}
    assert all(numbers[k] <= most[k] for k in numbers), numbers


@pytest.mark.parametrize("case", ["sound", "float32", "traced"])
def test_sound_runs_are_correct_with_equal_ranks(two_ranks, case):
    numbers = two_ranks[case]["numbers"]
    assert numbers["rank_gap"] == 0.0
    assert check.judge(numbers, limits())[0], numbers


@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange", "local_moments"])
def test_each_fault_is_not_correct(two_ranks, fault):
    assert not check.judge(two_ranks[fault]["numbers"], limits())[0]


def test_faults_of_the_exchange_part_the_ranks(two_ranks):
    assert two_ranks["exchange"]["numbers"]["rank_gap"] > 0
    assert two_ranks["local_moments"]["numbers"]["rank_gap"] > 0


def test_host_wait_reads_the_host_collectives(two_ranks, monkeypatch):
    from portbench import spans

    traced = two_ranks["traced"]
    summary, layer = traced["summary"], traced["layer"]
    steps = layer["span"]["steps"]
    assert summary["ddp.agree"]["calls"] == 2 * steps
    assert summary["ddp.reduce"]["calls"] == steps
    monkeypatch.setattr(spans, "recorded", lambda: summary)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = run.per_layer(bench, CELL, {"ddp_train_audio_s_per_s": {}}, layer, run.ROOT)
    want = 1e3 * (summary["ddp.agree"]["total_s"] + summary["ddp.reduce"]["total_s"]) / steps
    assert got["ddp.host_wait_ms"]["value"] == pytest.approx(want, rel=1e-12)
    assert "ddp.nccl_exposed_ms" not in got       # no NCCL kernel on the CPU
    assert {"ddp.mfu", "ddp.host_ms"} <= set(got)


def test_nccl_exposed_time_is_what_no_other_operation_hides():
    from portbench.harness import _exposed

    grouped = [((0, 10), "nccl"), ((5, 20), "K3"), ((18, 30), "nccl"), ((25, 26), "other"),
               ((40, 50), "nccl"), ((42, 44), "nccl")]
    exposed = _exposed(grouped)
    assert exposed["nccl"] == pytest.approx(24e-6) and exposed["K3"] == pytest.approx(8e-6)
    layer = {"span": {"steps": 2, "exposed": exposed,
                      "ops": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": [4, 3e-5]}}}
    reader = run.load_module(ROOT / "portbench" / "metrics" / "ddp.nccl_exposed_ms.py", "m")
    assert reader.read(layer) == pytest.approx(1e3 * 24e-6 / 2)
    assert reader.read({"span": dict(layer["span"], ops={})}) is None


def test_each_rank_gets_torchruns_variables_and_its_share_of_the_cores():
    cores = len(os.sched_getaffinity(0))
    env = ranks.rank_env({"RANK": "7", "PATH": "/bin"}, 2, 4, 29500)
    assert env["RANK"] == env["LOCAL_RANK"] == "2" and env["WORLD_SIZE"] == "4"
    assert env["MASTER_ADDR"] == "127.0.0.1" and env["MASTER_PORT"] == "29500"
    assert env["OMP_NUM_THREADS"] == str(max(1, cores // 4)) and env["PATH"] == "/bin"
    assert ranks.rank_env({"OMP_NUM_THREADS": "3"}, 0, 4, 1)["OMP_NUM_THREADS"] == "3"
