"""dsjax_torch's data-parallel training against one process and against
dsjax (CPU, gloo).

Two ranks run as subprocesses (tests/torch_ddp_worker.py) on a free port,
each with a 60 s group timeout and every ``communicate`` with a timeout,
on the tiny flagship (hidden 32, 2 LSTM layers, f32, SGD), rank 0's rows
padded to 64 frames and rank 1's to 48. They are held:

  * against one port process on the global batch padded to 64, its
    summed gradient divided by the world size (dsjax's ``loss / dp``):
    losses to rtol 1e-5, parameters after 2 steps to atol 1e-5 x each
    parameter's largest value, BatchNorm running stats to atol 1e-6 and
    equal across the ranks, WER and CER equal; the summed step of
    accumulate_grad_batches=2; the device SpecAugment masks of the union
    batch's rows, exactly;
  * against dsjax's single-process Trainer on 2 devices and the same global
    batch, from the same weights (``from_dsjax_variables``), at
    tests/test_torch_train.py's tolerances: grad_step's loss rtol 1e-5 and
    gradients atol 1e-4 x each parameter's largest gradient, the train
    steps' losses rtol 1e-4, running stats atol 1e-5 and rtol 1e-4, WER and
    CER equal;
  * ``agree_shapes`` against dsjax's (its all-gather replaced by the two
    ranks' shapes), both ranks raising on differing batch sizes or
    differing ragged_split counts (also through ``fit`` over a last bin
    too short to split), the BatchNorm moments of ranks holding different
    row counts, only rank 0 writing a checkpoint.

Also: the samplers against dsjax's, ``initialize`` with and without
torchrun's environment, the mesh settings (dsjax's make_mesh arithmetic;
tensor-parallel training itself is tests/test_torch_tensor_parallel.py's),
and ``python -m
torch.distributed.run --nproc_per_node 2 -m dsjax_torch.train`` on the CPU
(LSTM and GRU) with a one-process auto-resume from its checkpoint.
"""

import glob
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from dsjax import config as jax_config
from dsjax_torch import config
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model.convert import from_dsjax_variables
from dsjax_torch.parallel import distributed
from dsjax_torch.parallel.mesh import check_mesh
from tests import torch_ddp_worker as worker
from tests.synthetic_manifest import write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, port: int, world: int = 2) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in distributed.ENV}
    env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return env


def jax_argv():
    return [a for a in worker.cfg_argv(32, "cpu") if not a.startswith("trainer.device")]


def jax_run(jtrainer):
    """dsjax's Trainer on the global batch: grad_step's loss, gradients and
    running stats, then 2 train steps' losses, running stats and WER/CER."""
    batch = jax_batch(worker.global_batch(0))
    jstate = jtrainer.init_state()
    jgrads, jstats, jloss = jtrainer.grad_step(jstate, batch)
    grads = from_dsjax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads, "batch_stats": jstats}))
    jstate = jtrainer.init_state()
    losses = []
    for _ in range(2):
        jstate, loss = jtrainer.train_step(jstate, batch)
        losses.append(float(loss))
    stats = from_dsjax_variables(jax.tree_util.tree_map(np.asarray, jstate.variables()))
    return {"loss": float(jloss), "grads": grads, "losses": losses, "stats": stats,
            "wer_cer": jtrainer.validate(jstate, [batch])}


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """dsjax's Trainer on 2 devices and its initial weights; the two ranks'
    outputs from those weights; dsjax's run, made while the ranks run."""
    from dsjax.parallel.mesh import make_mesh
    from dsjax.train.loop import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("ddp")
    jcfg = jax_config.compose(jax_config.TrainConfig, jax_argv() + ["trainer.mesh_data=2"])
    jtrainer = JaxTrainer(jcfg, list(DEFAULT_LABELS),
                          mesh=make_mesh(2, 1, devices=jax.devices()[:2]))
    jstate = jtrainer.init_state()
    weights = from_dsjax_variables(jax.tree_util.tree_map(np.asarray, jstate.variables()))
    torch.save(weights, tmp / "weights.pt")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ddp_worker.py"),
         "--weights", str(tmp / "weights.pt"), "--out", str(tmp / f"rank{r}.pt"),
         "--ckpt", str(tmp / "ckpt")],
        cwd=ROOT, env=rank_env(r, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        jax_out = jax_run(jtrainer)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "DONE" in log, f"rank {r}:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"jax": jax_out, "weights": weights, "ranks": ranks, "ckpt": tmp / "ckpt"}


@pytest.fixture(scope="module")
def one_process(ddp):
    return worker.reference(worker.cfg_argv(32, "cpu"), ddp["weights"])


def jax_batch(batch):
    from dsjax.data.dataset import Batch as JaxBatch

    return JaxBatch(batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths,
                    batch.input_percentages, valid=batch.valid)


def assert_scaled(got, want, factor, what):
    """Each tensor within factor x its largest magnitude in ``want``."""
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=factor * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


# ----------------------------------------------------------------------------
# two ranks against one process on the global batch
# ----------------------------------------------------------------------------

def test_two_ranks_equal_one_process_on_the_global_batch(ddp, one_process):
    ref = one_process
    for out in ddp["ranks"]:
        assert (out["world"], out["backend"], out["ddp_wrapped"]) == (2, "gloo",
                                                                      "DistributedDataParallel")
        np.testing.assert_allclose(out["grad"]["loss"], ref["grad"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        assert_scaled(out["params"], ref["params"], 1e-5, f"rank {out['rank']}")
        for k, b in ref["buffers"].items():
            np.testing.assert_allclose(out["buffers"][k].numpy(), b.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
        assert out["wer_cer"] == ref["wer_cer"]
    r0, r1 = ddp["ranks"]
    # broadcast_buffers=False: the running stats agree because each rank
    # computed the same global statistics, not because rank 0's were copied
    for k in r0["buffers"]:
        assert torch.equal(r0["buffers"][k], r1["buffers"][k]), k


def test_ranks_span_their_host_collectives(ddp):
    """Under a profiler a step on each rank records the host collectives:
    the shapes' and the micro-batch count's all-gathers (``ddp.agree``)
    and the loss's all-reduce inside the backward (``ddp.reduce``)."""
    for out in ddp["ranks"]:
        spans = out["spans"]
        assert spans["ddp.agree"] == {"train.put_batch": 1, "train.step": 1}, spans
        assert spans["ddp.reduce"] == {"train.backward": 1}, spans
        assert spans["train.backward"] == {"train.step": 1}, spans


def test_batchnorm_statistics_are_global(ddp):
    """Per-rank statistics would give another loss: the two halves of the
    batch, each through one process, sum to a loss the ranks did not log."""
    from dsjax_torch.train.loop import Trainer

    trainer = Trainer(config.compose(config.TrainConfig, worker.cfg_argv(32, "cpu")),
                      list(DEFAULT_LABELS))
    per_rank = 0.0
    for r in range(2):
        state = trainer.init_state()
        state.model.load_state_dict(ddp["weights"])
        per_rank += float(trainer.grad_step(state, worker.local_rows(worker.global_batch(0),
                                                                     r))[1])
    logged = ddp["ranks"][0]["grad"]["loss"]
    assert abs(per_rank / 2 - logged) > 1e-3 * logged, (per_rank / 2, logged)


def test_accumulated_step_on_two_ranks_equals_the_summed_step(ddp, one_process):
    ref = one_process["accum"]
    for out in ddp["ranks"]:
        np.testing.assert_allclose(out["accum"]["loss"], ref["loss"], rtol=1e-5)
        assert_scaled(out["accum"]["params"], ref["params"], 1e-5, "accumulated")


def test_device_masks_on_two_ranks_are_the_union_batch_rows(ddp, one_process):
    union = one_process["masks"]
    assert 0 < float(union.mean()) < 1
    for out in ddp["ranks"]:
        r = out["rank"]
        assert torch.equal(out["masks"], union[r * worker.ROWS:(r + 1) * worker.ROWS])


def test_differing_ragged_split_counts_and_batch_sizes_raise_on_every_rank(ddp):
    for out in ddp["ranks"]:
        assert "disagree on the micro-batches" in out["errors"]["ragged"]
        assert "[2, 1]" in out["errors"]["ragged"]
        # through fit: the short bin's rank takes train_step, the other
        # train_step_accum, and both agree the count first
        assert re.search(r"disagree on the micro-batches.*: \[(2, 1|1, 2)\] \(by rank\)",
                         out["errors"]["fit_ragged"])
        assert "batch sizes of array 0 differ across ranks: [2, 3]" in \
            out["errors"]["agree_shapes"]


def test_batchnorm_moments_weigh_ranks_by_their_counts(ddp):
    """Ranks of 3 and 7 rows: the moments and the unbiased factor are the
    union's, and each rank's input gradient is its block of the union's
    gradient of the ranks' summed losses."""
    x = torch.cat(worker.moments_inputs()).requires_grad_()
    mean = x.mean(0)
    var = (x * x).mean(0) - mean * mean
    w = worker.moments_weights()
    (worker.WORLD * (w[0] * mean + w[1] * var)).sum().backward()
    for out in ddp["ranks"]:
        got, r = out["moments"], out["rank"]
        np.testing.assert_allclose(got["mean"].numpy(), mean.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["var"].numpy(), var.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["unbias"].numpy(), [10 / 9], rtol=1e-7)
        rows = slice(0, 3) if r == 0 else slice(3, 10)
        np.testing.assert_allclose(got["grad"].numpy(), x.grad[rows].numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_agree_shapes_pads_as_dsjax(ddp, monkeypatch):
    from dsjax.parallel import multihost as jax_multihost
    from jax.experimental import multihost_utils

    inputs = [worker.agree_inputs(r) for r in range(2)]
    shapes = np.stack([np.concatenate([np.asarray(a.shape, np.int64) for a in arrays])
                       for arrays in inputs])
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda x: shapes)
    for out in ddp["ranks"]:
        want = jax_multihost.agree_shapes(inputs[out["rank"]])
        assert [a.shape for a in out["agreed"]] == [(2, 4), (2, 5, 6)]
        for got, w in zip(out["agreed"], want):
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w)


def test_only_rank_zero_writes_the_checkpoint_and_load_model_reads_it(ddp):
    from dsjax_torch.inference import load_model
    from dsjax_torch.model.convert import load_checkpoint
    from dsjax_torch.train.checkpoint import CheckpointHandler

    r0, r1 = ddp["ranks"]
    handler = CheckpointHandler(str(ddp["ckpt"]))
    assert r1["written"] == [] and r0["written"] == [handler.path()]
    assert handler.latest_step() == 2 and handler.best_step() == 2
    assert not any(k.startswith("module.")
                   for k in load_checkpoint(handler.path())["state_dict"])
    model = load_model(handler.path(), device="cpu").model
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), r0["params"][k]), k


# ----------------------------------------------------------------------------
# against dsjax
# ----------------------------------------------------------------------------

def test_two_ranks_equal_dsjax_trainer_on_the_global_batch(ddp):
    want = ddp["jax"]
    for out in ddp["ranks"]:
        np.testing.assert_allclose(out["grad"]["loss"], want["loss"], rtol=1e-5)
        for k, g in out["grad"]["grads"].items():
            w = want["grads"][k].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-4)
        for k, b in out["buffers"].items():
            np.testing.assert_allclose(b.numpy(), want["stats"][k].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)
        assert out["wer_cer"] == pytest.approx(want["wer_cer"], rel=1e-12)


# ----------------------------------------------------------------------------
# samplers, initialize, mesh settings
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("start_index", [0, 3])
def test_distributed_samplers_match_dsjax(replicas, epoch, start_index):
    from dsjax.data import sampler as jax_sampler
    from dsjax_torch.data import sampler

    for name in ("DistributedBucketSampler", "DistributedOrderedSampler"):
        for rank in range(replicas):
            got, want = (getattr(mod, name)(23, 2, seed=5, num_replicas=replicas, rank=rank)
                         for mod in (sampler, jax_sampler))
            for s in (got, want):
                s.set_epoch(epoch)
                s.start_index = start_index
            assert len(got) == len(want)
            assert list(got) == list(want), (name, rank)


@pytest.mark.parametrize("n_items, replicas", [(3, 3), (2, 3), (1, 4)])
def test_distributed_samplers_wrap_when_fewer_bins_than_replicas(n_items, replicas):
    from dsjax.data import sampler as jax_sampler
    from dsjax_torch.data import sampler

    for name in ("DistributedBucketSampler", "DistributedOrderedSampler"):
        batches = []
        for rank in range(replicas):
            got = list(getattr(sampler, name)(n_items, 2, seed=1, num_replicas=replicas,
                                               rank=rank))
            assert got == list(getattr(jax_sampler, name)(n_items, 2, seed=1,
                                                          num_replicas=replicas, rank=rank))
            assert len(got) == 1
            batches += got
        assert sorted({i for b in batches for i in b}) == list(range(n_items))


def test_initialize_is_a_noop_without_torchrun_env(monkeypatch):
    for key in distributed.ENV:
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize("cpu") is False
    assert not distributed.active()
    assert (distributed.world_size(), distributed.rank(), distributed.is_main_process()) == \
        (1, 0, True)
    distributed.barrier()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="incomplete"):
        distributed.initialize("cpu")


INIT_SCRIPT = """
import os, socket
import torch.distributed as dist
from dsjax_torch.parallel import distributed, multihost
try:
    distributed.initialize('cpu', backend='nccl', timeout_s=60)
except Exception as e:
    print('FAILED_JOIN', type(e).__name__, distributed.active())
with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    os.environ['MASTER_PORT'] = str(s.getsockname()[1])
assert distributed.initialize('cpu', timeout_s=60) is True
assert distributed.initialize('cpu') is False
print('GROUP', dist.get_backend(), dist.get_backend(distributed.host_group()),
      distributed.world_size(), distributed.rank(), distributed.is_main_process())
print('SUMS', multihost.sum_ints([3, 4]))
distributed.barrier()
distributed.destroy()
print('AFTER', distributed.active())
"""


def test_initialize_forms_a_gloo_group_of_one_and_a_failed_join_raises():
    """Under WORLD_SIZE=1 ``initialize`` joins a gloo group (and its host
    group) and leaves it; an init_process_group that fails (no NCCL on
    this build) raises instead of going on alone."""
    out = subprocess.run([sys.executable, "-c", INIT_SCRIPT], cwd=ROOT,
                         env=rank_env(0, free_port(), world=1), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    failed = lines["FAILED_JOIN"].split()
    assert failed[1] == "False" and failed[0] in ("RuntimeError", "ValueError")
    assert lines["GROUP"] == "gloo gloo 1 0 True"
    assert lines["SUMS"] == "[3, 4]" and lines["AFTER"] == "False"


@pytest.mark.parametrize("data, model, dcn, world, exc", [
    (-1, 1, 1, 2, None),
    (2, 1, 1, 2, None),
    (1, 1, 2, 2, None),
    (2, 1, 2, 4, None),
    (-1, 2, 1, 2, None),
    (1, 1, 1, 2, ValueError),
    (-1, 1, 3, 2, ValueError),
    (4, 1, 2, 4, ValueError),
    (2, 2, 1, 4, None),
    (1, 2, 2, 4, None),
    (-1, 3, 1, 4, ValueError),
    (2, 2, 1, 2, ValueError),
])
def test_mesh_settings_are_checks_against_the_world_size(data, model, dcn, world, exc):
    """dsjax's make_mesh arithmetic: mesh_model x mesh_dcn divides the world
    and mesh_data is -1 or world / (mesh_model x mesh_dcn)."""
    if exc is None:
        check_mesh(data, model, dcn, world)
    else:
        with pytest.raises(exc, match="mesh_"):
            check_mesh(data, model, dcn, world)


@pytest.mark.parametrize("override, exc, match", [
    ("trainer.mesh_model=2", ValueError, "does not divide the world size 1"),
    ("trainer.mesh_dcn=2", ValueError, "does not divide"),
    ("trainer.devices=2", NotImplementedError, "torch.distributed.run"),
])
def test_trainer_outside_torchrun_refuses_more_than_one_card(override, exc, match):
    from dsjax_torch.train.loop import Trainer

    cfg = config.compose(config.TrainConfig, worker.cfg_argv(16, "cpu") + [override])
    with pytest.raises(exc, match=match):
        Trainer(cfg, list(DEFAULT_LABELS))


# ----------------------------------------------------------------------------
# the torchrun entry point
# ----------------------------------------------------------------------------

def rank_logs(log_dir):
    logs = []
    for r in range(2):
        (path,) = glob.glob(os.path.join(log_dir, "*", "attempt_0", str(r), "stdout.log"))
        logs.append(open(path).read())
    return logs


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_torchrun_trains_an_epoch_on_two_ranks_and_one_process_resumes(tmp_path, capsys, rnn):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    dsjax_torch.train`` on the CPU: both ranks log the same losses and
    WER/CER, rank 0 writes the checkpoints and the metrics; then one process
    auto-resumes from them for a second epoch (dsjax's elastic resize)."""
    from dsjax_torch import workflows
    from dsjax_torch.train.checkpoint import CheckpointHandler

    train = write_manifest(str(tmp_path), "train", [1.0, 0.8, 1.2, 0.6, 0.9, 0.7, 1.1, 0.5],
                           seed=1)
    val = write_manifest(str(tmp_path), "val", [0.9, 1.1, 0.7], seed=2)
    ckpt = tmp_path / "ckpt"
    argv = [f"data.train_path={train}", f"data.val_path={val}", "data.batch_size=2",
            "data.num_workers=1", "model.hidden_size=16", "model.hidden_layers=2",
            f"model.rnn_type={rnn}", "trainer.precision=32", "trainer.device=cpu",
            f"checkpoint.dirpath={ckpt}", "trainer.log_every_n_steps=1",
            f"trainer.log_dir={tmp_path / 'metrics'}"]
    env = rank_env(0, 0)
    for key in distributed.ENV:
        env.pop(key)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "--log-dir", str(tmp_path / "logs"), "--redirects", "3", "-m", "dsjax_torch.train",
         *argv, "trainer.max_epochs=1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    logs = rank_logs(str(tmp_path / "logs"))
    assert out.returncode == 0, out.stderr[-3000:] + "".join(logs)[-3000:]
    steps = [re.findall(r"^epoch 0 step (\d+/\d+) loss (\S+)", log, re.M) for log in logs]
    ends = [re.findall(r"^epoch 0: loss (\S+) wer (\S+) cer (\S+)", log, re.M) for log in logs]
    assert steps[0] == steps[1] and [s for s, _ in steps[0]] == ["1/2", "2/2"]
    assert ends[0] == ends[1] and len(ends[0]) == 1
    assert "logging metrics to" in logs[0] and "logging metrics to" not in logs[1]
    assert len(open(tmp_path / "metrics" / "metrics.jsonl").readlines()) == 3

    handler = CheckpointHandler(str(ckpt))
    assert handler.latest_step() == 2
    state = workflows.train(config.compose(config.TrainConfig, argv + [
        "trainer.max_epochs=2", "load_auto_checkpoint=true"]))
    assert "auto-resumed from step 2" in capsys.readouterr().out
    assert (state.step, state.epoch) == (6, 1) and handler.latest_step() == 6
