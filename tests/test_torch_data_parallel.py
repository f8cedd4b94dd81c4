"""dsjax_torch's data-parallel inference against dsjax's, on the CPU.

dsjax's ``ModelBundle`` shards a batch over conftest's 8 fake CPU devices;
the port's bundle holds 8 CPU replicas (``["cpu"] * 8``, or
``num_cpu_devices=8`` through ``load_model``), splits the batch into 8
row shards and gathers their posteriors onto the first device. On the same
weights (a seeded reference-layout state, H=64, 2
layers, the head scaled so that posteriors are decisive, carried to the
port by ``from_dsjax_variables``):

  * the forward, features and raw int16 audio, batch 8 with half the rows
    at half length: posteriors within 1e-5 of dsjax's data-parallel ones,
    out_lens equal; a batch of 7 and a carried forward take the
    single-replica path;
  * the decoders (greedy, the device beam by the scan and by K7's plain
    version) on the replicas' posteriors give one replica's strings, and
    the device-LM beam gives dsjax's on its sharded posteriors, its tables
    copied to no other device on a second decode;
  * ``workflows.evaluate`` with ``num_cpu_devices=8`` prints dsjax's Ref/Hyp
    lines and returns its WER/CER; with 3 replicas (the batch padded to 6)
    it equals the single-replica port;
  * the server on 2 replicas answers 8 concurrent /transcribe requests with
    the single-replica strings;
  * ``tools/dsjax_checkpoint_to_torch.py`` converts a checkpoint directory
    written by dsjax's own ``CheckpointHandler`` (best, else last) into a
    port checkpoint whose posteriors match dsjax's ``load_model``, and the
    port's ``load_model`` on such a directory names the tool.
"""

import importlib.util
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsjax import config as jax_config
from dsjax.decode.beam_device import DeviceBeamDecoder as JaxBeamDecoder
from dsjax.inference import ModelBundle as JaxModelBundle
from dsjax.inference import load_model as jax_load_model
from dsjax.model.torch_import import convert_state_dict
from dsjax.workflows import evaluate as jax_evaluate
from dsjax_torch import config
from dsjax_torch.audio.features import pad_audio_for_device
from dsjax_torch.decode import beam_device
from dsjax_torch.decode.beam_device import DeviceBeamDecoder
from dsjax_torch.decode.greedy import GreedyDecoder
from dsjax_torch.decode.lm_device import PackedLM
from dsjax_torch.inference import ModelBundle, load_decoder, load_model, local_devices
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model import convert
from dsjax_torch.model.ds2 import DeepSpeech2
from dsjax_torch.ops import beam as beam_ops
from dsjax_torch.server import BatchWorker, _Request, serve, shutdown
from dsjax_torch.workflows import evaluate
from tests.test_torch_eval import SECONDS, corpus, pairs, run  # noqa: F401 (fixture)
from tests.test_torch_model import ATOL, CLASSES, RTOL, features, reference_state
from tests.test_torch_server import audio, post

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, LAYERS = 64, 2
REPLICAS = 8
# posteriors of the two packages' forwards (tests/test_torch_eval.py)
FORWARD_ATOL = 1e-5
# dsjax's sharded device-LM test (tests/test_multichip.py)
ARPA = """\\data\\
ngram 1=5
ngram 2=2

\\1-grams:
-1.0\t<s>\t-0.5
-1.2\t</s>
-0.8\tAB\t-0.3
-1.1\tA\t-0.4
-2.0\t<unk>

\\2-grams:
-0.2\tAB A
-0.4\tA AB

\\end\\
"""
LM_LABELS = ["_", "'", "A", "B", "C", " "]


@pytest.fixture(scope="module")
def bundles():
    """dsjax's data-parallel bundle on the 8 fake devices, and the port's
    model on the same weights (from_dsjax_variables)."""
    assert len(jax.devices()) == REPLICAS
    state = reference_state(seed=31, hidden=HIDDEN, layers=LAYERS, fc_scale=4.0)
    params, stats = convert_state_dict(state, LAYERS, True)
    variables = {"params": params, "batch_stats": stats}
    from dsjax.model.ds2 import DeepSpeech2 as JaxDeepSpeech2

    jmodel = JaxDeepSpeech2(num_classes=CLASSES, spect_cfg=jax_config.SpectConfig(),
                            model_cfg=jax_config.BiDirectionalConfig(hidden_size=HIDDEN,
                                                                     hidden_layers=LAYERS),
                            dtype=jnp.float32)
    jbundle = JaxModelBundle(jmodel, variables, list(DEFAULT_LABELS), jax_config.SpectConfig())
    assert jbundle.mesh is not None
    model = DeepSpeech2(CLASSES, config.SpectConfig(),
                        config.BiDirectionalConfig(hidden_size=HIDDEN, hidden_layers=LAYERS))
    model.load_state_dict(convert.from_dsjax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    return jbundle, model


def port_bundles(model, replicas=REPLICAS):
    dp = ModelBundle(model, list(DEFAULT_LABELS), config.SpectConfig(), ["cpu"] * replicas)
    one = ModelBundle(model, list(DEFAULT_LABELS), config.SpectConfig(), "cpu")
    return dp, one


def record_forwards(monkeypatch):
    """The rows of each replica's forward: one list a ModelBundle.forward
    (one entry for a batch that did not shard)."""
    calls = []
    forward, forward_on = ModelBundle.forward, ModelBundle._forward_on

    def outer(self, *args, **kwargs):
        calls.append([])
        return forward(self, *args, **kwargs)

    def inner(self, dev, spect, lengths, carry):
        calls[-1].append(len(spect))
        return forward_on(self, dev, spect, lengths, carry)

    monkeypatch.setattr(ModelBundle, "forward", outer)
    monkeypatch.setattr(ModelBundle, "_forward_on", inner)
    return calls


def raw_batch(b=REPLICAS, seconds=0.8):
    """(B, L_pad) int16 audio of B utterances, every other one at half
    length, and their frame counts."""
    spect = config.SpectConfig()
    ys = [audio(60 + i, seconds if i % 2 == 0 else seconds / 2) for i in range(b)]
    n_valid = np.array([pad_audio_for_device(y, spect)[1] for y in ys], np.int32)
    items = [pad_audio_for_device(y, spect, int(n_valid.max())) for y in ys]
    return (np.stack([np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16)
                      for yp, _ in items]), n_valid)


def feature_batch(b=REPLICAS):
    return features(5, b, 64, [64 if i % 2 == 0 else 32 for i in range(b)])


@pytest.mark.parametrize("kind", ["features", "raw audio"])
def test_forward_matches_dsjax_data_parallel(bundles, kind, monkeypatch):
    jbundle, model = bundles
    dp, one = port_bundles(model)
    assert dp.devices == [torch.device("cpu")] * REPLICAS and len(dp.replicas) == 1
    x, lens = feature_batch() if kind == "features" else raw_batch()
    calls = record_forwards(monkeypatch)
    probs, out_lens, carry = dp.forward(x, lens)
    assert calls == [[1] * REPLICAS] and carry is None
    assert probs.shape[0] == out_lens.shape[0] == REPLICAS
    want, want_lens, _ = jbundle.forward(x, lens)
    assert len(want.sharding.device_set) == REPLICAS
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), atol=FORWARD_ATOL, rtol=0)
    single, single_lens, _ = one.forward(x, lens)
    assert torch.equal(single_lens, out_lens)
    torch.testing.assert_close(probs, single, atol=FORWARD_ATOL, rtol=0)

    # a batch the replica count does not divide runs on the first device
    p7, l7, _ = dp.forward(x[:7], lens[:7])
    assert calls[-1] == [7] and l7.shape == (7,)
    np.testing.assert_allclose(p7.numpy(), np.asarray(want)[:7], atol=FORWARD_ATOL, rtol=0)


def test_carried_forward_never_shards(bundles, monkeypatch):
    jbundle, model = bundles
    dp, one = port_bundles(model)
    x, lens = feature_batch()
    _, _, carry = one.forward(x[..., :32], np.minimum(lens, 32))
    calls = record_forwards(monkeypatch)
    got = dp.forward(x[..., 32:], np.maximum(lens - 32, 0), carry)
    assert calls == [[REPLICAS]]
    want = one.forward(x[..., 32:], np.maximum(lens - 32, 0), carry)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_local_devices():
    cpu = torch.device("cpu")
    assert local_devices("cpu") == [cpu]
    assert local_devices("cpu", 3) == [cpu] * 3
    assert local_devices("cpu,cpu") == [cpu, cpu]
    assert local_devices(["cpu", cpu]) == [cpu, cpu]
    bundle = ModelBundle(DeepSpeech2(CLASSES, config.SpectConfig(), config.BiDirectionalConfig(
        hidden_size=16, hidden_layers=1)), list(DEFAULT_LABELS), config.SpectConfig(), "cpu")
    assert bundle.devices == [cpu] and bundle.device == cpu and bundle.shards(8) == 1
    with pytest.raises(ValueError, match="no replica"):
        local_devices("meta")


def fused_plain(monkeypatch):
    """Send every decode K7 can take to it (on CPU tensors, its plain
    version) and count the calls."""
    calls = []
    fused = beam_ops.fused_beam_scan

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return fused(*args, **kwargs)

    monkeypatch.setattr(beam_ops, "fused_beam_scan", counting)
    monkeypatch.setattr(DeviceBeamDecoder, "_fused_ok", lambda self, lp: beam_device._fusable(
        lp.shape[0], lp.shape[-1], self.beam_width, self.cutoff_top_n, self.cutoff_prob,
        self._lm))
    return calls


@pytest.mark.parametrize("route", ["greedy", "beam scan", "beam K7 plain"])
def test_decoders_match_one_replica(bundles, route, monkeypatch):
    _, model = bundles
    dp, one = port_bundles(model)
    x, lens = raw_batch()
    probs, out_lens, _ = dp.forward(x, lens)
    single, single_lens, _ = one.forward(x, lens)
    calls = fused_plain(monkeypatch) if route == "beam K7 plain" else None
    dec = (GreedyDecoder(DEFAULT_LABELS) if route == "greedy"
           else DeviceBeamDecoder(DEFAULT_LABELS, beam_width=6))
    got = dec.decode(probs, out_lens, n_best=1)
    want = dec.decode(single, single_lens, n_best=1)
    assert got[0] == want[0] and any(s[0] for s in got[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a[0], b[0])
    if calls is not None:
        # one call of every row for each decode
        assert calls == [REPLICAS, REPLICAS]


def test_device_lm_beam_matches_dsjax_sharded(tmp_path, monkeypatch):
    """The device-LM beam gives dsjax's strings on its sharded posteriors;
    decoding again copies the tables nowhere (they were packed on the CPU,
    where the posteriors lie)."""
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA)
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((REPLICAS, 40, len(LM_LABELS))).astype(np.float32)
    logits[..., 5] += 1.0
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    copies = []
    to = PackedLM.to

    def counting(self, device):
        copies.append(torch.device(device))
        return to(self, device)

    monkeypatch.setattr(PackedLM, "to", counting)
    dec = DeviceBeamDecoder(LM_LABELS, beam_width=8, lm_path=str(arpa), alpha=0.6, beta=0.4)
    want, _ = dec.decode(torch.from_numpy(probs), n_best=1)
    assert dec.decode(torch.from_numpy(probs), n_best=1)[0] == want and copies == []

    jax_dec = JaxBeamDecoder(LM_LABELS, beam_width=8, lm_path=str(arpa), alpha=0.6, beta=0.4)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.array(jax.devices()), ("data",))
    sharded = jax.device_put(probs, NamedSharding(mesh, PartitionSpec("data")))
    assert jax_dec.decode(sharded, n_best=1)[0] == want


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_evaluate_over_replicas_matches_dsjax(corpus, decoder, monkeypatch):  # noqa: F811
    """num_cpu_devices=8 and batch_size=4: each batch pads to 8 rows and
    shards one a replica, as dsjax's evaluate on its 8 fake devices."""
    path, manifest, _ = corpus
    argv = [f"model.model_path={path}", f"test_path={manifest}", "batch_size=4",
            "num_workers=1", f"lm.decoder_type={decoder}", "lm.beam_width=8"]
    calls = record_forwards(monkeypatch)
    got, got_out = run(evaluate, config.compose(
        config.EvalConfig, argv + ["device=cpu", f"num_cpu_devices={REPLICAS}"]))
    assert calls == [[1] * REPLICAS] * -(-len(SECONDS) // 4)
    want, want_out = run(jax_evaluate, jax_config.compose(jax_config.EvalConfig, argv))
    assert len(pairs(got_out)) == 2 * len(SECONDS)
    assert pairs(got_out) == pairs(want_out)
    assert got == want


def test_evaluate_pads_to_the_replica_count(corpus, monkeypatch):  # noqa: F811
    """3 replicas: batches of 4 pad to 6 rows, 2 a replica; the output is
    the single-replica port's."""
    path, manifest, _ = corpus
    argv = [f"model.model_path={path}", f"test_path={manifest}", "batch_size=4",
            "num_workers=1", "lm.decoder_type=beam", "lm.beam_width=8", "device=cpu"]
    calls = record_forwards(monkeypatch)
    got, got_out = run(evaluate, config.compose(config.EvalConfig, argv + ["num_cpu_devices=3"]))
    assert calls == [[2] * 3] * -(-len(SECONDS) // 4)
    want, want_out = run(evaluate, config.compose(config.EvalConfig, argv))
    assert pairs(got_out) == pairs(want_out) and len(pairs(got_out)) == 2 * len(SECONDS)
    assert got == want


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    state = reference_state(seed=21, hidden=32, layers=2, fc_scale=4.0)
    path = str(tmp_path_factory.mktemp("dp") / "model.ckpt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(path, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)
    return path


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_server_over_two_replicas_matches_one(checkpoint, decoder, monkeypatch):
    """8 concurrent /transcribe requests through a 2-replica bundle: the
    batches shard over the replicas and the strings are those of a
    single-replica worker given the 8 as one batch."""
    cfg = config.compose(config.ServerConfig, [
        f"model.model_path={checkpoint}", "host=127.0.0.1", "port=0", "device=cpu",
        "num_cpu_devices=2", "max_batch=8", "batch_timeout_ms=500", "warmup_seconds=0.5",
        f"lm.decoder_type={decoder}", "lm.beam_width=6"])
    httpd, worker = serve(cfg)
    try:
        assert len(worker.bundle.devices) == 2
        calls = record_forwards(monkeypatch)
        ys = [audio(80 + i, 0.3 + 0.1 * i) for i in range(8)]
        results = [None] * len(ys)

        def client(i):
            results[i] = post(httpd.server_address[1], "/transcribe", ys[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert [status for status, _ in results] == [200] * len(ys), results
        assert any(len(c) == 2 for c in calls)   # a batch split over the replicas
    finally:
        shutdown(httpd, worker)
    one = load_model(checkpoint, device="cpu")
    ref = BatchWorker(one, load_decoder(one.labels, cfg.lm), cfg)
    try:
        reqs = [_Request(y) for y in ys]
        ref._process(reqs)
        for req in reqs:
            assert req.event.wait(timeout=120) and req.error is None, req.error
        want = [req.result for req in reqs]
    finally:
        ref.close()
    assert [got for _, got in results] == want
    assert any(r["output"][0]["transcription"] for r in want)


# --- tools/dsjax_checkpoint_to_torch.py ---------------------------------

TOOL = os.path.join(ROOT, "tools", "dsjax_checkpoint_to_torch.py")


def tool():
    spec = importlib.util.spec_from_file_location("dsjax_checkpoint_to_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dsjax_states():
    """dsjax's TrainConfig (H=32, 2 layers) and two train states of it with
    different weights, at steps 1 and 2."""
    from dsjax.labels import DEFAULT_LABELS as JAX_LABELS
    from dsjax.train.loop import Trainer

    cfg = jax_config.compose(jax_config.TrainConfig, [
        "model.hidden_size=32", "model.hidden_layers=2", "trainer.precision=32"])
    state = Trainer(cfg, list(JAX_LABELS)).init_state()
    states = []
    for step, scale in ((1, 1.5), (2, 0.5)):
        params = jax.tree_util.tree_map(lambda a: a * scale, state.params)
        states.append(state.replace(params=params, step=jnp.asarray(step, jnp.int32)))
    return cfg, list(JAX_LABELS), states


def test_tool_converts_the_best_checkpoint(tmp_path):
    from dsjax.train.checkpoint import CheckpointHandler

    cfg, labels, (best, last) = dsjax_states()
    ckpt = str(tmp_path / "ckpt")
    handler = CheckpointHandler(ckpt, cfg=cfg, labels=labels)
    handler.save(best, {"wer": 0.2})
    handler.save(last, {"wer": 0.9})
    handler.close()
    out = str(tmp_path / "model.pt")
    assert tool().convert(ckpt, out) == "best"

    bundle = load_model(out, device="cpu")
    assert bundle.labels == labels
    want_state = convert.from_dsjax_variables(jax.tree_util.tree_map(np.asarray, best.variables()))
    got_state = bundle.model.state_dict()
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    x, lens = features(7, 3, 96, [96, 50, 20])
    probs, out_lens, _ = bundle.forward(x, lens)
    want, want_lens, _ = jax_load_model(ckpt).forward(x, lens)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    with pytest.raises(IsADirectoryError, match="dsjax_checkpoint_to_torch.py"):
        load_model(ckpt, device="cpu")


def test_tool_takes_the_last_checkpoint_without_a_best(tmp_path):
    """The command line, on a directory that holds only a last checkpoint."""
    from dsjax.train.checkpoint import CheckpointHandler

    cfg, labels, (_, last) = dsjax_states()
    ckpt = str(tmp_path / "ckpt")
    handler = CheckpointHandler(ckpt, cfg=cfg, labels=labels)
    handler.save(last, {"wer": 0.9}, last_only=True)
    handler.close()
    out = str(tmp_path / "model.pt")
    done = subprocess.run([sys.executable, TOOL, ckpt, out], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "from the last checkpoint" in done.stdout
    got_state = load_model(out, device="cpu").model.state_dict()
    want_state = convert.from_dsjax_variables(jax.tree_util.tree_map(np.asarray, last.variables()))
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
