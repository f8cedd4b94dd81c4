"""dsjax_torch's tensor-parallel training (``trainer.mesh_model`` = M > 1)
against dsjax's Trainer on a (data, model) mesh, and against the port at
M = 1 (CPU, gloo).

Each case runs world ranks as subprocesses (tests/torch_tp_worker.py) on a
free port, with a 60 s group timeout and every ``communicate`` with a
timeout, at H=32, 2 layers, f32, AdamW with trainer.gradient_clip_val=5
(the clip engages: the first gradient's global norm is asserted above it);
data index d takes row block d of the global batch, its last block's rows
trimmed to 48 of the 64 frames. The reference is dsjax's Trainer on
``make_mesh(dp, M)`` over the faked CPU devices, fed the global batch from
the same weights. Cases: the BiLSTM at (world 2, M 2) and (world 4, M 2);
the BiGRU, the BiRNN and the unidirectional GRU + Lookahead at (2, 2); the
BiGRU on (3, 3), where M divides the recurrent weights' 3H (a gate a rank)
but not the head's H = 32, so the head stays replicated as dsjax's
``param_shardings`` leaves it.

Against dsjax, at test_torch_distributed.py's dsjax tolerances: grad_step's
loss rtol 1e-5 and gradients (gathered whole) atol 1e-4 x each
parameter's largest gradient; the 2 clipped AdamW steps' losses rtol 1e-4,
running stats atol 1e-5 and rtol 1e-4, WER and CER equal. The parameters
after the AdamW steps are held apart from the gradients, as
tests/test_torch_train.py holds them: each rank's clip norm and steps
against dsjax's optax chain run on the whole tree with the gradients the
rank's clip was handed (see that test), and against dsjax's parameters
within 2 x 2 lr (AdamW's first steps are about lr x sign(g), so an element
whose gradient is near zero in both packages can move 2 lr apart a step:
measured up to 1.84 lr; the port's data-parallel run at M = 1 on the same
data groups equals the M = 2 run bit for bit, so the difference is the
packages', not the sharding's).

Against the port at M = 1 in one process (one rank of world 1: the same
global BatchNorm path), at test_torch_distributed.py's DDP tolerances:
losses rtol 1e-5, parameters atol 1e-5 x each parameter's largest value,
running stats atol 1e-6. Also: each rank holds only its blocks of the
sharded parameters and of their AdamW moments (shapes), replicated
parameters are bit-identical across a model group, the accumulated step of
2 micro-batches equals the summed step, the ranks of a model group load the
same bins, a run saved at M = 2 is the unsharded file that load_model,
evaluate and the server read, resuming M=2 -> M=1 and M=1 -> M=2 equals the
uninterrupted run, and a dsjax run of mesh_model=2 converts with
tools/dsjax_checkpoint_to_torch.py and continues under torchrun at
mesh_model=2 as dsjax's own resume does.
"""

import json
import os
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
from tests import torch_tp_worker as worker
from tests.synthetic_manifest import write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
ROWS, FRAMES, CLIP = 4, 64, 5.0
LR = 1.5e-4                    # optim.learning_rate's default
# two AdamW steps, each at most about lr from the other package's where an
# element's gradient changes sign between them
ADAM_STEPS_ATOL = 2 * 2 * LR

# name: (world, mesh_model, hidden, model overrides)
CASES = {
    "bilstm_w2": (2, 2, 32, []),
    "bilstm_w4": (4, 2, 32, []),
    "bigru_w2": (2, 2, 32, ["model.rnn_type=gru"]),
    "birnn_w2": (2, 2, 32, ["model.rnn_type=rnn"]),
    "gru_lookahead_w2": (2, 2, 32, ["model=unidirectional", "model.rnn_type=gru",
                                    "model.lookahead_context=3"]),
    "fallback_bigru_w3": (3, 3, 32, ["model.rnn_type=gru"]),
}
# the parameters dsjax's _param_spec names, by the port's names
SPEC = ("weight_ih", "weight_hh", "bias_ih", "bias_hh", "fc.weight")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, port: int, world: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in distributed.ENV}
    env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return env


def start(tmp, name, world, mesh_model, hidden, model_argv, jobs, *extra):
    """Start world ranks of the worker; returns what ``finish`` waits for."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_tp_worker.py"),
         "--weights", str(tmp / "weights.pt"), "--out", str(tmp / f"{name}_{r}.pt"),
         "--mesh-model", str(mesh_model), "--model-argv", json.dumps(model_argv),
         "--hidden", str(hidden), "--clip", str(CLIP), "--jobs", jobs, *extra],
        cwd=ROOT, env=rank_env(r, port, world), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return tmp, name, procs


def finish(started):
    tmp, name, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "DONE" in log, f"{name} rank {r}:\n{log[-4000:]}"
    return [torch.load(tmp / f"{name}_{r}.pt", weights_only=False) for r in range(len(procs))]


def jax_argv(hidden, mesh_model, model_argv):
    return [a for a in worker.cfg_argv(hidden, "cpu", mesh_model, model_argv, clip=CLIP)
            if not a.startswith("trainer.device")]


def jax_batch(batch):
    from dsjax.data.dataset import Batch as JaxBatch

    return JaxBatch(batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths,
                    batch.input_percentages, valid=batch.valid)


def jax_trainer(dp, mesh_model, hidden, model_argv):
    from dsjax.parallel.mesh import make_mesh
    from dsjax.train.loop import Trainer as JaxTrainer

    jcfg = jax_config.compose(jax_config.TrainConfig, jax_argv(hidden, mesh_model, model_argv))
    return JaxTrainer(jcfg, list(DEFAULT_LABELS),
                      mesh=make_mesh(dp, mesh_model, devices=jax.devices()[:dp * mesh_model]))


def to_port(tree):
    return from_dsjax_variables(jax.tree_util.tree_map(np.asarray, tree))


def jax_run(jtrainer, dp):
    """dsjax's Trainer on the global batch: grad_step's loss and gradients,
    then 2 train steps' losses, parameters, running stats and WER/CER."""
    batch = jax_batch(worker.global_batch(dp, ROWS, FRAMES, 0))
    jstate = jtrainer.init_state()
    jgrads, jstats, jloss = jtrainer.grad_step(jstate, batch)
    grads = to_port({"params": jgrads, "batch_stats": jstats})
    jstate = jtrainer.init_state()
    losses = []
    for _ in range(2):
        jstate, loss = jtrainer.train_step(jstate, batch)
        losses.append(float(loss))
    after = to_port(jstate.variables())
    return {"loss": float(jloss), "grads": grads, "losses": losses, "after": after,
            "wer_cer": jtrainer.validate(jstate, [batch])}


MAIN = "bilstm_w2"
SAMPLED = ("bilstm_w2", "bilstm_w4")   # the cases whose ranks report their bins
CONVERSION = "dsjax_mesh_model_2"      # the dsjax run the tool converts
# every case and the conversion run in this many threads: dsjax's compiles
# release the GIL, and each case waits mostly on them
THREADS = 2
_FUTURES = {}


def run_one(name, tmp):
    """One case: dsjax's run on its mesh, made while the ranks run from
    dsjax's initial weights, and the optax replay of each rank's steps; for
    bilstm_w2 also the port at M = 1 in one rank, both runs' checkpoints
    and the resumes across M."""
    world, mesh_model, hidden, model_argv = CASES[name]
    dp = world // mesh_model
    jtrainer = jax_trainer(dp, mesh_model, hidden, model_argv)
    weights = to_port(jtrainer.init_state().variables())
    torch.save(weights, tmp / "weights.pt")
    main = name == MAIN
    jobs = "grad,steps,clip" + (",accum" if main else "") + (
        ",samplers" if name in SAMPLED else "")
    manifest = write_manifest(str(tmp), "corpus", [0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 0.55],
                              seed=3)
    runs = [start(tmp, "tp", world, mesh_model, hidden, model_argv, jobs, "--manifest", manifest,
                  *(["--ckpt", str(tmp / "ckpt_m2")] if main else []))]
    if main:
        runs.append(start(tmp, "m1", 1, 1, hidden, model_argv, jobs, "--manifest", manifest,
                          "--ckpt", str(tmp / "ckpt_m1")))
    out = {"name": name, "world": world, "mesh_model": mesh_model, "dp": dp, "tmp": tmp,
           "weights": weights, "jax": jax_run(jtrainer, dp), "manifest": manifest}
    out["ranks"] = finish(runs[0])
    out["replayed"] = [optax_replay(out, rank) for rank in out["ranks"]]
    if main:
        from dsjax_torch.train.checkpoint import CheckpointHandler

        out["m1"] = finish(runs[1])[0]
        f1, f2 = (CheckpointHandler(str(tmp / d)).path() for d in ("ckpt_m1", "ckpt_m2"))
        resumed = [start(tmp, "resume_m2", world, mesh_model, hidden, model_argv, "none",
                         "--resume", f1),
                   start(tmp, "resume_m1", 1, 1, hidden, model_argv, "none", "--resume", f2)]
        out["resume_m2"], out["resume_m1"] = finish(resumed[0]), finish(resumed[1])[0]
        out["files"] = {"m1": f1, "m2": f2}
    return out


def run_case(name, tmp_path_factory):
    """A case's (or the conversion run's) results, every one of them started
    at the first call, in THREADS threads."""
    if not _FUTURES:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(THREADS)
        for n in sorted(CASES) + [CONVERSION]:
            tmp = tmp_path_factory.mktemp(n)
            _FUTURES[n] = pool.submit(conversion_run if n == CONVERSION else run_one, n, tmp)
        pool.shutdown(wait=False)
    return _FUTURES[name].result()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    return run_case(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def main(tmp_path_factory):
    """bilstm_w2, with the port at M = 1, the checkpoints and the resumes."""
    return run_case(MAIN, tmp_path_factory)


def assert_scaled(got, want, factor, what):
    """Each tensor within factor x its largest magnitude in ``want``."""
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=factor * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def post_wav(port, path):
    """POST a WAV file to the server's /transcribe: (status, JSON body)."""
    import http.client

    boundary = "tensorparallelboundary"
    with open(path, "rb") as f:
        payload = f.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/transcribe", body=body,
                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def params_of(named):
    return {k: v for k, v in named.items() if "running" not in k and "num_batches" not in k}


# ----------------------------------------------------------------------------
# against dsjax's Trainer on a (data, model) mesh
# ----------------------------------------------------------------------------

def test_tensor_parallel_step_matches_dsjax(case):
    want = case["jax"]
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in params_of(want["grads"]).values()])))
    assert norm > CLIP, f"the clip does not engage: global norm {norm}"
    for out in case["ranks"]:
        assert (out["world"], out["backend"]) == (case["world"], "gloo")
        np.testing.assert_allclose(out["grad"]["loss"], want["loss"], rtol=1e-5)
        for k, g in out["grad"]["grads"].items():
            w = want["grads"][k].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-4)
        # AdamW's update is about lr x sign(g) an element: where the two
        # packages' gradients of an element near zero differ in sign, the
        # parameter moves 2 lr apart; nothing moves further
        for k, w in params_of(want["after"]).items():
            np.testing.assert_allclose(out["params"][k].numpy(), w.numpy(), rtol=0,
                                       atol=ADAM_STEPS_ATOL + 1e-6 * float(w.abs().max()),
                                       err_msg=f"{case['name']} rank {out['rank']} {k}")
        for k, b in out["buffers"].items():
            np.testing.assert_allclose(b.numpy(), want["after"][k].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)
        assert out["wer_cer"] == pytest.approx(want["wer_cer"], rel=1e-12)


def test_ranks_hold_only_their_blocks_as_dsjax_shards(case):
    """Each rank's sharded parameters and their AdamW moments are its block
    of dsjax's sharding (dim 1 over M, where M divides it); the others are
    whole and bit-identical across the model group."""
    m, weights = case["mesh_model"], case["weights"]
    want = {k for k in params_of(weights)
            if k.endswith(SPEC) and weights[k].shape[1] % m == 0}
    fallback = {"fc.weight"} if case["name"].startswith("fallback") else set()
    assert want == {k for k in params_of(weights)
                    if k.startswith("rnns.") or k == "fc.weight"} - fallback
    for out in case["ranks"]:
        assert set(out["sharded"]) == want and set(out["sharded"].values()) == {1}
        for k, w in params_of(weights).items():
            shape = list(w.shape)
            if k in want:
                shape[1] //= m
            assert out["shapes"]["params"][k] == tuple(shape), k
            assert out["shapes"]["moments"][k] == {"exp_avg": tuple(shape),
                                                   "exp_avg_sq": tuple(shape)}, k
    groups = {}
    for out in case["ranks"]:
        groups.setdefault(out["data_index"], []).append(out)
    assert len(groups) == case["dp"] and all(len(g) == m for g in groups.values())
    for members in groups.values():
        assert sorted(o["model_index"] for o in members) == list(range(m))
        for o in members[1:]:
            assert set(o["held"]) == set(params_of(weights)) - want
            for k, p in o["held"].items():
                assert torch.equal(p, members[0]["held"][k]), k
            for k, b in o["buffers"].items():
                assert torch.equal(b, members[0]["buffers"][k]), k




def optax_replay(case, out):
    """dsjax's optax chain (global-norm clip, then AdamW) run on the whole
    parameters with the gradients the rank's clip was handed: the two steps
    the rank should have taken."""
    import jax.numpy as jnp
    import optax

    from dsjax.train import state as jax_state

    world, mesh_model, hidden, model_argv = CASES[case["name"]]
    jcfg = jax_config.compose(jax_config.TrainConfig, jax_argv(hidden, mesh_model, model_argv))
    tx = jax_state.make_optimizer(jcfg.optim, jcfg.trainer)
    params = {k: jnp.asarray(v.numpy()) for k, v in params_of(case["weights"]).items()}
    opt_state = tx.init(params)
    for step in out["clipped"]:
        grads = {k: jnp.asarray(step["grads"][k].numpy()) for k in params}
        opt_state = jax_state.set_lr(opt_state, jax_state.epoch_lr(jcfg.optim, jnp.int32(0)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def test_sharded_clip_and_adamw_equal_optax_on_the_whole_tree(case):
    """The clip's norm (shards' squares summed over the model group, the
    replicated ones counted once) is the global norm of the whole gradient
    tree (against f64, rtol 1e-5: f32 rounding, measured 1.8e-6), it
    engages, and the AdamW steps on the blocks equal dsjax's optax chain
    (clip, then AdamW) on the whole parameters: 1e-6 x each tensor's
    largest value (tests/test_torch_train.py's optimizer tolerance, an ulp
    of a BatchNorm scale) plus 1e-4 x its largest change over the steps,
    for the tensors that start at zero (measured 8.5e-6: optax's f32 norm
    is 2.5e-5 from f64 here, and the second step weighs the two steps'
    clip factors)."""
    for out, want in zip(case["ranks"], case["replayed"]):
        assert len(out["clipped"]) == 2
        for step in out["clipped"]:
            norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in step["grads"].values()))
            np.testing.assert_allclose(step["norm"], norm, rtol=1e-5)
            assert norm > CLIP, norm
        before = params_of(case["weights"])
        for k, w in want.items():
            change = np.abs(w - before[k].numpy()).max()
            np.testing.assert_allclose(out["params"][k].numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max() + 1e-4 * change, err_msg=k)


# ----------------------------------------------------------------------------
# against the port at M = 1, accumulation, samplers (bilstm_w2)
# ----------------------------------------------------------------------------

def test_two_ranks_at_mesh_model_2_equal_one_process_at_1(main):
    """The same weights and global batch at M = 2 on two ranks and at M = 1
    in one rank: test_torch_distributed.py's DDP tolerances (measured: equal
    bit for bit), and validation's summed WER/CER counts equal."""
    ref = main["m1"]
    assert (ref["world"], ref["sharded"]) == (1, {})
    for out in main["ranks"]:
        np.testing.assert_allclose(out["grad"]["loss"], ref["grad"]["loss"], rtol=1e-5)
        assert_scaled(out["grad"]["grads"], ref["grad"]["grads"], 1e-5, "gradient")
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        assert_scaled(out["params"], ref["params"], 1e-5, "parameter")
        for k, b in ref["buffers"].items():
            np.testing.assert_allclose(out["buffers"][k].numpy(), b.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
        assert out["wer_cer"] == ref["wer_cer"]
        # the error and reference counts summed over the ranks: each row once
        # (a model group of 2 counting its rows twice would keep the rates)
        assert out["wer_counts"] == ref["wer_counts"] and ref["wer_counts"][1] > 0


def test_accumulated_step_equals_the_summed_step(main):
    """train_step_accum of 2 micro-batches at M = 2 (DDP's no_sync on the
    first) against two grad_steps summed through apply_grads on the same
    ranks, and against train_step_accum at M = 1."""
    for out in main["ranks"]:
        for want in (out["summed"], main["m1"]["accum"]):
            np.testing.assert_allclose(out["accum"]["loss"], want["loss"], rtol=1e-5)
            assert_scaled(out["accum"]["params"], want["params"], 1e-5, "accumulated")
            for k, b in want["buffers"].items():
                np.testing.assert_allclose(out["accum"]["buffers"][k].numpy(), b.numpy(),
                                           rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", SAMPLED)
def test_model_group_ranks_load_the_same_bins(name, tmp_path_factory):
    """The ranks of a model group get the same bins, each data index
    dsjax's distributed sampler's share for dp replicas (the plain samplers
    at dp = 1)."""
    from dsjax.data import sampler as jax_sampler

    run = run_case(name, tmp_path_factory)
    n = 9
    for out in run["ranks"]:
        got = out["samplers"]
        dp, d = run["dp"], out["data_index"]
        if dp > 1:
            want = {"train": jax_sampler.DistributedBucketSampler(n, ROWS, seed=7, num_replicas=dp,
                                                                  rank=d),
                    "val": jax_sampler.DistributedOrderedSampler(n, ROWS, seed=7, num_replicas=dp,
                                                                 rank=d)}
        else:
            want = {"train": jax_sampler.BucketBatchSampler(n, ROWS, seed=7),
                    "val": jax_sampler.OrderedBatchSampler(n, ROWS, seed=7)}
        for epoch in (0, 1):
            want["train"].set_epoch(epoch)
            assert got[f"train {epoch}"] == [list(b) for b in want["train"]], (out["rank"], epoch)
        assert got["val"] == [list(b) for b in want["val"]]
        first = run["ranks"][d * run["mesh_model"]]
        assert got == first["samplers"]
    if run["dp"] > 1:
        shares = [run["ranks"][d * run["mesh_model"]]["samplers"]["train 0"]
                  for d in range(run["dp"])]
        assert shares[0] != shares[1]


# ----------------------------------------------------------------------------
# checkpoints: the unsharded file, and resuming across mesh_model
# ----------------------------------------------------------------------------

def test_checkpoint_at_mesh_model_2_is_the_whole_file_that_every_reader_loads(main, tmp_path):
    """Rank 0 alone writes; the file holds the whole model and whole AdamW
    moments, in the layout mesh_model=1 writes, equal to the ranks' gathered
    parameters; load_model, evaluate and the server read it unchanged and
    answer as they do from the M = 1 run's file."""
    from dsjax_torch import workflows
    from dsjax_torch.inference import load_decoder, load_model, run_transcribe
    from dsjax_torch.model.convert import load_checkpoint
    from dsjax_torch.server import serve, shutdown

    r0, r1 = main["ranks"]
    assert r0["written"] == [main["files"]["m2"]] and r1["written"] == []
    f1, f2 = (load_checkpoint(main["files"][k]) for k in ("m1", "m2"))
    assert {k: tuple(v.shape) for k, v in f2["state_dict"].items()} == \
        {k: tuple(v.shape) for k, v in f1["state_dict"].items()}
    shapes = [{k: tuple(v.shape) for k, v in s.items() if torch.is_tensor(v)}
              for s in f1["optimizer"]["state"].values()]
    assert [{k: tuple(v.shape) for k, v in s.items() if torch.is_tensor(v)}
            for s in f2["optimizer"]["state"].values()] == shapes
    assert (f2["step"], f2["epoch"]) == (2, 0)
    model = load_model(main["files"]["m2"], device="cpu").model
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), r0["params"][k]), k
    for k, b in model.named_buffers():
        assert torch.equal(b, r0["buffers"][k]), k

    wav = os.path.join(os.path.dirname(main["manifest"]), "wav", "corpus_0.wav")
    results = {}
    for which in ("m1", "m2"):
        path = main["files"][which]
        evaluated = workflows.evaluate(config.compose(config.EvalConfig, [
            f"model.model_path={path}", f"test_path={main['manifest']}", "batch_size=4",
            "device=cpu", "verbose=false", "num_workers=1"]))
        bundle = load_model(path, device="cpu")
        direct = run_transcribe(audio_path=wav, bundle=bundle,
                                decoder=load_decoder(bundle.labels, config.LMConfig()))[0][0][0]
        cfg = config.compose(config.ServerConfig, [f"model.model_path={path}", "host=127.0.0.1",
                                                   "port=0", "device=cpu", "warmup_seconds=0"])
        httpd, srv = serve(cfg)
        try:
            status, body = post_wav(httpd.server_address[1], wav)
        finally:
            shutdown(httpd, srv)
        assert status == 200, body
        results[which] = (evaluated, direct, body["output"][0]["transcription"])
    assert results["m1"] == results["m2"]


def test_resume_across_mesh_model_equals_the_uninterrupted_run(main):
    """The M = 1 run's file resumed at M = 2 takes the step M = 1 took after
    saving, and the M = 2 run's file resumed at M = 1 the step M = 2 took:
    DDP tolerances (measured: bit for bit)."""
    pairs = [(out["resume"], main["m1"]["step3"]) for out in main["resume_m2"]]
    pairs.append((main["resume_m1"]["resume"], main["ranks"][0]["step3"]))
    for got, want in pairs:
        assert got["steps"] == (2, 3)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert_scaled(got["params"], want["params"], 1e-5, "resumed")
    assert main["resume_m2"][0]["sharded"] and not main["resume_m1"]["sharded"]


# ----------------------------------------------------------------------------
# a dsjax run of mesh_model=2, converted and continued under torchrun
# ----------------------------------------------------------------------------

def conversion_run(name, tmp_path):
    """dsjax's Trainer on make_mesh(1, 2) trains 2 steps, saves mid-epoch
    and resumes its own save for the 3 steps left; the directory converts
    with the tool, and torchrun continues it at mesh_model=2."""
    from dsjax.parallel.mesh import make_mesh
    from dsjax.train.checkpoint import CheckpointHandler as JaxHandler
    from dsjax.train.loop import Trainer as JaxTrainer
    from dsjax_torch.model.convert import from_reference_state_dict, load_checkpoint
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from tests.test_torch_resume import N_SAVED, argv_of, jax_batches, np_tree, tool

    argv = argv_of(str(tmp_path), "adam") + ["trainer.mesh_model=2"]
    jcfg = jax_config.compose(jax_config.TrainConfig, argv)
    trainer = JaxTrainer(jcfg, list(DEFAULT_LABELS),
                         mesh=make_mesh(1, 2, devices=jax.devices()[:2]))
    state = trainer.init_state()
    for b in jax_batches(jcfg)[:N_SAVED]:
        state, loss = trainer.train_step(state, b)
    out = {"saved": np_tree(state)}
    jax_dir = str(tmp_path / "dsjax_ckpt")
    handler = JaxHandler(jax_dir, cfg=jcfg, labels=list(DEFAULT_LABELS))
    handler.save(state, {"loss": float(loss)}, extra={"start_index": N_SAVED, "epoch": 0},
                 last_only=True)
    state = handler.restore(trainer.init_state())
    handler.close()
    out["losses"] = []
    for b in jax_batches(jcfg, start_index=N_SAVED):
        state, loss = trainer.train_step(state, b)
        out["losses"].append(float(loss))
    out["after"] = np_tree(state)
    out["jax_meta"] = json.load(open(os.path.join(jax_dir, "meta.json")))

    port_dir = str(tmp_path / "port_ckpt")
    out["converted"] = tool().convert(jax_dir, port_dir)
    out["port_meta"] = json.load(open(os.path.join(port_dir, "meta.json")))
    env = rank_env(0, 0, 1)
    for key in distributed.ENV:
        env.pop(key)
    log_dir = tmp_path / "logs"
    out["done"] = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "dsjax_torch.train", *argv, "trainer.device=cpu", f"checkpoint.dirpath={port_dir}",
         "load_auto_checkpoint=true", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
         "trainer.limit_val_batches=1", f"trainer.log_dir={log_dir}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    if out["done"].returncode == 0:
        out["logged"] = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
        handler = CheckpointHandler(port_dir)
        out["last_step"] = handler.latest_step()
        out["final"] = from_reference_state_dict(load_checkpoint(handler.path())["state_dict"])
    return out


def test_dsjax_tensor_parallel_run_converts_and_continues_at_mesh_model_2(tmp_path_factory):
    """dsjax's Trainer on make_mesh(1, 2) trains 2 steps, saves mid-epoch
    and resumes its own save for the 3 steps left; the directory (meta.json
    says mesh_model=2) converts with the tool, and ``python -m
    torch.distributed.run --nproc_per_node 2 -m dsjax_torch.train
    trainer.mesh_model=2 load_auto_checkpoint=true`` trains those 3 steps
    on the same batches: dsjax's losses and parameters at
    test_torch_resume.py's tolerances."""
    from tests.test_torch_resume import (FIRST_RTOL, LOSS_RTOL, N_LEFT, N_SAVED,
                                         assert_updates_close)

    run = run_case(CONVERSION, tmp_path_factory)
    assert run["jax_meta"]["config"]["trainer"]["mesh_model"] == 2
    assert run["converted"] == "last"
    assert config.from_dict(run["port_meta"]["config"], config.TrainConfig).trainer.mesh_model == 2
    assert run["done"].returncode == 0, run["done"].stderr[-4000:]
    got = [r["loss"] for r in run["logged"] if "loss" in r]
    np.testing.assert_allclose(got[:1], run["losses"][:1], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got, run["losses"], rtol=LOSS_RTOL)
    assert run["last_step"] == N_SAVED + N_LEFT
    before = from_dsjax_variables(run["saved"].variables())
    assert_updates_close(params_of(before), params_of(run["final"]), run["saved"].params,
                         run["after"].params, "mesh_model=2 continuation")
