"""dsjax_torch's HTTP server against dsjax's BatchWorker on the same weights.

One checkpoint (reference layout, written by the port's save_checkpoint)
loads into both packages. The port serves it over HTTP on 127.0.0.1:0 with
device="cpu"; dsjax's BatchWorker answers the same audio by direct calls.
The head is scaled so that every frame's top-1/top-2 posterior margin in
dsjax's outputs exceeds 100x the model tolerance (1e-5), and the test
asserts that margin, so a transcript comparison cannot flip on a near tie.
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest

from dsjax import config as jax_config
from dsjax.inference import load_model as jax_load_model
from dsjax.inference import run_transcribe as jax_run_transcribe
from dsjax.decode.greedy import GreedyDecoder as JaxGreedyDecoder
from dsjax.labels import DEFAULT_LABELS
from dsjax.server import BatchWorker as JaxBatchWorker
from dsjax.server import _Request as JaxRequest
from dsjax_torch import config
from dsjax_torch.audio.io import save_wav
from dsjax_torch.inference import run_transcribe
from dsjax_torch.model import convert
from dsjax_torch.server import _parse_upload, serve, shutdown
from tests.test_torch_model import reference_state

SR = 16000
MIN_MARGIN = 100 * 1e-5
SETTINGS = dict(max_batch=4, batch_timeout_ms=30.0, chunk_size_seconds=1.0,
                warmup_seconds=0.5)


def audio(seed, seconds):
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f = 200 + 60 * seed
    return (0.2 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def wav_bytes(y):
    buf = io.BytesIO()
    save_wav(buf, y, SR)
    return buf.getvalue()


def multipart(filename, payload):
    boundary = "torchportboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: audio/wav\r\n\r\n"
            ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def post(port, path, y):
    body, ctype = multipart("a.wav", wav_bytes(y))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    state = reference_state(seed=21, hidden=32, layers=2, fc_scale=4.0)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(path, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)

    cfg = config.compose(config.ServerConfig, [f"model.model_path={path}", "host=127.0.0.1",
                                               "port=0", "device=cpu"])
    for k, v in SETTINGS.items():
        setattr(cfg, k, v)
    httpd, worker = serve(cfg)

    jax_cfg = jax_config.ServerConfig(**SETTINGS)
    jax_bundle = jax_load_model(path)
    forwards = []
    jax_forward = jax_bundle.forward

    def recording_forward(spect, lengths, carry=None):
        out = jax_forward(spect, lengths, carry)
        forwards.append((np.asarray(lengths), np.asarray(out[0]), np.asarray(out[1])))
        return out

    jax_bundle.forward = recording_forward
    jax_worker = JaxBatchWorker(jax_bundle, JaxGreedyDecoder(DEFAULT_LABELS), jax_cfg)
    yield httpd.server_address[1], worker, jax_worker, forwards
    shutdown(httpd, worker)
    jax_worker._long_pool.shutdown(wait=True)


def assert_decisive(forwards):
    """Every real frame dsjax produced has a top-1/top-2 margin > MIN_MARGIN."""
    checked = 0
    for lengths, probs, out_lens in forwards:
        for i, n in enumerate(out_lens):
            if lengths[i] == 1:  # batch padding rows, sliced off by the server
                continue
            top2 = np.sort(probs[i, :n], axis=-1)[:, -2:]
            assert np.all(top2[:, 1] - top2[:, 0] > MIN_MARGIN)
            checked += n
    assert checked > 0


def jax_transcribe(jax_worker, ys):
    reqs = [JaxRequest(y) for y in ys]
    jax_worker._process(reqs)
    for r in reqs:
        assert r.event.wait(timeout=120) and r.error is None, r.error
    return [r.result for r in reqs]


def test_health(servers):
    port = servers[0]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/health")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}


def test_concurrent_and_long_transcribe_match_dsjax(servers):
    port, _, jax_worker, forwards = servers
    # four short requests batched together, one long upload (> 1 s) that
    # goes chunk by chunk on the side pool with the RNN state carried
    ys = [audio(i, s) for i, s in enumerate([0.3, 0.55, 0.8, 0.95])] + [audio(9, 2.5)]
    results = [None] * len(ys)

    def client(i):
        results[i] = post(port, "/transcribe", ys[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [status for status, _ in results] == [200] * len(ys), results
    want = jax_transcribe(jax_worker, ys)
    assert_decisive(forwards)
    for (_, got), ref in zip(results, want):
        assert got == ref
        assert got["_meta"]["decoder"]["type"] == "greedy"
    assert any(r["output"][0]["transcription"] for r in want)


def test_stream_session_matches_dsjax(servers):
    port, _, jax_worker, forwards = servers
    chunks = [audio(20 + i, 0.4) for i in range(3)]
    got = []
    for i, y in enumerate(chunks):
        status, payload = post(port, f"/stream?session=s1&final={int(i == 2)}", y)
        assert status == 200, payload
        got.append(payload)
    want = [jax_worker.stream_chunk("s1", y, final=i == 2) for i, y in enumerate(chunks)]
    assert_decisive(forwards)
    assert got == want
    assert got[-1]["final"] is True and got[-1]["transcription"]


def test_bad_requests(servers):
    port = servers[0]
    body, ctype = multipart("x.aiff", b"FORM....AIFF")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/transcribe", body=body, headers={"Content-Type": ctype})
    assert conn.getresponse().status == 415
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/transcribe", body=b"hi", headers={"Content-Type": "text/plain"})
    assert conn.getresponse().status == 400
    assert _parse_upload("audio/wav", b"RIFFdata") == ("upload.wav", b"RIFFdata")


@pytest.mark.parametrize("chunk_s", [-1.0, 1.0])
def test_run_transcribe_matches_dsjax(servers, tmp_path, chunk_s):
    """File transcription, one shot and chunk by chunk with the carry."""
    _, worker, jax_worker, forwards = servers
    path = str(tmp_path / "a.wav")
    save_wav(path, audio(30, 2.3), SR)
    got = run_transcribe(path, worker.bundle, worker.decoder, chunk_s)
    want = jax_run_transcribe(path, jax_worker.bundle, jax_worker.decoder, chunk_s)
    assert_decisive(forwards)
    assert got[0] == want[0] and got[0][0][0]
    np.testing.assert_array_equal(got[1][0][0], want[1][0][0])


@pytest.fixture(scope="module")
def beam_servers(tmp_path_factory):
    """The same weights served with lm.decoder_type=beam by the port over
    HTTP and by dsjax's BatchWorker with its device beam."""
    from dsjax.decode.beam_device import DeviceBeamDecoder as JaxBeamDecoder

    state = reference_state(seed=21, hidden=32, layers=2, fc_scale=4.0)
    path = str(tmp_path_factory.mktemp("beam") / "model.ckpt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(path, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)
    cfg = config.compose(config.ServerConfig, [f"model.model_path={path}", "host=127.0.0.1",
                                               "port=0", "device=cpu", "lm.decoder_type=beam",
                                               "lm.beam_width=6"])
    for k, v in SETTINGS.items():
        setattr(cfg, k, v)
    httpd, worker = serve(cfg)
    jax_worker = JaxBatchWorker(jax_load_model(path), JaxBeamDecoder(DEFAULT_LABELS, beam_width=6),
                                jax_config.ServerConfig(**SETTINGS))
    yield httpd.server_address[1], worker, jax_worker
    shutdown(httpd, worker)
    jax_worker._long_pool.shutdown(wait=True)


def test_beam_transcribe_and_stream_match_dsjax(beam_servers):
    """Beam /transcribe batches (n_best=1) and a /stream session carrying
    the beam state give dsjax's transcripts; a one-chunk session equals
    the one-shot /transcribe of the same audio."""
    port, worker, jax_worker = beam_servers
    ys = [audio(40 + i, s) for i, s in enumerate([0.35, 0.6, 0.9])]
    results = [None] * len(ys)

    def client(i):
        results[i] = post(port, "/transcribe", ys[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [status for status, _ in results] == [200] * len(ys), results
    want = jax_transcribe(jax_worker, ys)
    assert [got for _, got in results] == want
    assert any(r["output"][0]["transcription"] for r in want)

    chunks = [audio(50 + i, 0.4) for i in range(3)]
    got = [post(port, f"/stream?session=b&final={int(i == 2)}", y)[1]
           for i, y in enumerate(chunks)]
    assert got == [jax_worker.stream_chunk("b", y, final=i == 2) for i, y in enumerate(chunks)]
    assert got[-1]["transcription"]
    one = post(port, "/stream?session=one&final=1", ys[2])[1]
    assert one["transcription"] == results[2][1]["output"][0]["transcription"]


@pytest.fixture(scope="module", params=["bigru", "unigru"])
def gru_servers(request, tmp_path_factory):
    """The port's server and dsjax's BatchWorker on one GRU checkpoint:
    5 x BiGRU or 5 x GRU + Lookahead 20 of tests/golden_gru.py at width 32,
    the head scaled for decisive frames."""
    from tests.golden_gru import gru_state

    state = gru_state(request.param, hidden=32, layers=2)
    state["fc.0.module.1.weight"] *= 400.0
    path = str(tmp_path_factory.mktemp("gru") / "model.ckpt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(path, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)
    cfg = config.compose(config.ServerConfig, [f"model.model_path={path}", "host=127.0.0.1",
                                               "port=0", "device=cpu"])
    for k, v in SETTINGS.items():
        setattr(cfg, k, v)
    httpd, worker = serve(cfg)
    jax_bundle = jax_load_model(path)
    forwards = []
    jax_forward = jax_bundle.forward

    def recording_forward(spect, lengths, carry=None):
        out = jax_forward(spect, lengths, carry)
        forwards.append((np.asarray(lengths), np.asarray(out[0]), np.asarray(out[1])))
        return out

    jax_bundle.forward = recording_forward
    jax_worker = JaxBatchWorker(jax_bundle, JaxGreedyDecoder(DEFAULT_LABELS),
                                jax_config.ServerConfig(**SETTINGS))
    yield httpd.server_address[1], worker, jax_worker, forwards
    shutdown(httpd, worker)
    jax_worker._long_pool.shutdown(wait=True)


def test_gru_server_transcribe_stream_and_mp3_match_dsjax(gru_servers):
    """A GRU checkpoint (bidirectional, or unidirectional with Lookahead,
    the model users stream with) serves batched and chunked /transcribe, a
    /stream session carrying (h,) per layer, and an mp3 upload decoded by the
    port's native library, each equal to dsjax's BatchWorker."""
    from dsjax.cpp.audio_binding import FMT_MP3, available_formats, decode_bytes
    from tests import codec_fixtures

    port, worker, jax_worker, forwards = gru_servers
    assert worker.bundle.model.rnns[0].rnn_type.value == "gru"
    ys = [audio(30 + i, s) for i, s in enumerate([0.35, 0.6, 0.9])] + [audio(39, 2.4)]
    results = [None] * len(ys)

    def client(i):
        results[i] = post(port, "/transcribe", ys[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [status for status, _ in results] == [200] * len(ys), results
    assert [got for _, got in results] == jax_transcribe(jax_worker, ys)

    chunks = [audio(40 + i, 0.45) for i in range(3)]
    got = [post(port, f"/stream?session=g&final={int(i == 2)}", y)[1]
           for i, y in enumerate(chunks)]
    want = [jax_worker.stream_chunk("g", y, final=i == 2) for i, y in enumerate(chunks)]
    assert got == want and got[-1]["transcription"]
    assert_decisive(forwards)

    if not available_formats() & FMT_MP3:
        pytest.skip("libmpg123 unavailable")
    blob = codec_fixtures.encode_mp3(audio(50, 0.8), SR)
    if blob is None:
        pytest.skip("libmp3lame unavailable")
    body, ctype = multipart("a.mp3", blob)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/transcribe", body=body, headers={"Content-Type": ctype})
    r = conn.getresponse()
    assert r.status == 200
    assert json.loads(r.read()) == jax_transcribe(jax_worker, [decode_bytes(blob)[0]])[0]


@pytest.fixture(scope="module", params=["device LM beam", "host LM beam"])
def lm_servers(request, tmp_path_factory):
    """The same weights served with a 3-gram LM (tests/test_torch_lm.py's
    seeded LM over A, B and C, and every 1-3 letter word of A-E) by the port
    over HTTP and by dsjax's BatchWorker: lm.device_beam=true gives the
    device beam with the LM fused, false the host beam."""
    from dsjax.decode.beam import BeamCTCDecoder as JaxBeamCTCDecoder
    from dsjax.decode.beam_device import DeviceBeamDecoder as JaxBeamDecoder
    from dsjax_torch.decode.beam import BeamCTCDecoder
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from tests.synthetic_lm import seeded_trigram, write_arpa

    tmp = tmp_path_factory.mktemp("lmserve")
    ngrams = seeded_trigram(n_words=300, n_bi=1000, n_tri=1000)
    for a in "ABCDE":
        for w in (a, a + a, a + "B" + a):
            ngrams[0].setdefault((w,), (-2.5, -0.2))
    lm_path = write_arpa(tmp / "lm.arpa", ngrams)
    state = reference_state(seed=21, hidden=32, layers=2, fc_scale=4.0)
    path = str(tmp / "model.ckpt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(path, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)
    device_beam = request.param == "device LM beam"
    lm = dict(lm_path=lm_path, alpha=0.8, beta=0.3, beam_width=6)
    cfg = config.compose(config.ServerConfig, [
        f"model.model_path={path}", "host=127.0.0.1", "port=0", "device=cpu",
        "lm.decoder_type=beam", f"lm.device_beam={str(device_beam).lower()}", "lm.lm_workers=2"]
        + [f"lm.{k}={v}" for k, v in lm.items()])
    for k, v in SETTINGS.items():
        setattr(cfg, k, v)
    httpd, worker = serve(cfg)
    if device_beam:
        assert isinstance(worker.decoder, DeviceBeamDecoder) and worker.decoder._lm is not None
        jax_decoder = JaxBeamDecoder(DEFAULT_LABELS, **lm)
    else:
        assert isinstance(worker.decoder, BeamCTCDecoder) and worker.decoder.lm is not None
        jax_decoder = JaxBeamCTCDecoder(DEFAULT_LABELS, num_processes=2, **lm)
    jax_worker = JaxBatchWorker(jax_load_model(path), jax_decoder,
                                jax_config.ServerConfig(**SETTINGS))
    yield httpd.server_address[1], worker, jax_worker
    shutdown(httpd, worker)
    jax_worker._long_pool.shutdown(wait=True)


def test_lm_transcribe_and_stream_match_dsjax(lm_servers):
    """/transcribe with the LM, on either route, gives dsjax's transcripts.
    A /stream session gives dsjax's: the device beam carries the LM word
    state from chunk to chunk; the host beam, which cannot stream,
    collapses greedily, reading its labels from its label map."""
    port, worker, jax_worker = lm_servers
    ys = [audio(60 + i, s) for i, s in enumerate([0.45, 0.7, 1.0])]
    results = [None] * len(ys)

    def client(i):
        results[i] = post(port, "/transcribe", ys[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [status for status, _ in results] == [200] * len(ys), results
    assert [got for _, got in results] == jax_transcribe(jax_worker, ys)

    chunks = [audio(70 + i, 0.4) for i in range(3)]
    got = [post(port, f"/stream?session=lm&final={int(i == 2)}", y)
           for i, y in enumerate(chunks)]
    assert [status for status, _ in got] == [200] * 3, got
    assert [g for _, g in got] == [jax_worker.stream_chunk("lm", y, final=i == 2)
                                   for i, y in enumerate(chunks)]
    assert got[-1][1]["transcription"]
