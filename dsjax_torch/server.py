"""HTTP inference server (stdlib): the counterpart of dsjax/server.py.

POST /transcribe with a multipart audio file (or a raw audio body) returns
the transcription JSON; POST /stream?session=ID&final=0|1 feeds one chunk of
an incremental session that carries the RNN state; GET /health answers ok.
Concurrent requests are padded into one batch, with the batch size rounded
up to a power of two and T to a multiple of 64 frames, as dsjax does, so the
two servers see the same shapes. A batch whose size the bundle's replica
count divides (``device=cuda``: every visible card) takes the data-parallel
forward; smaller batches, chunked uploads and /stream sessions run on the
first card. Audio longer than chunk_size_seconds runs chunk by chunk with
the RNN state carried, on a side pool. With
``lm.decoder_type=beam`` batches decode with the device beam search (the LM
fused into it with ``lm.lm_path`` and ``lm.device_beam=true``), and a
/stream session carries the beam state from chunk to chunk, so its
transcript equals a one-shot beam decode of the chunks so far. The host
beam with an LM (``lm.device_beam=false``) cannot stream: /stream collapses
greedily for it. A Conformer (``model=conformer``) carries no state, so
/stream refuses it with status 400.

    python -m dsjax_torch.server model.model_path=model.pt port=8888 [device=cpu]
        [num_cpu_devices=N]      # N CPU replicas, dsjax's fake CPU devices
"""

from __future__ import annotations

import json
import queue
import re
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np
import torch

from dsjax_torch.audio import native
from dsjax_torch.audio.features import FeatureExtractor, spectrogram_np
from dsjax_torch.audio.io import load_audio, resample
from dsjax_torch.config import ConformerConfig, ServerConfig, compose_cli
from dsjax_torch.inference import ModelBundle, decode_results, load_decoder, load_model

ALLOWED_EXTENSIONS = {"wav", "flac"}
COMPRESSED_EXTENSIONS = {"mp3", "ogg", "oga", "opus", "webm"}


def _bucket(n: int, multiple: int = 64) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class _Request:
    def __init__(self, audio: np.ndarray):
        self.audio = audio
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[str] = None


class _StreamSession:
    """Server-held state of one /stream session: the RNN carry, the decoder's
    carry (greedy: text so far and the last argmax label; beam: the search
    state and the W hypotheses), and running feature statistics over every
    frame seen, so chunks normalize by the utterance's statistics rather
    than their own."""

    def __init__(self, blank_index: int = 0):
        self.carry = None
        self.text: str = ""
        self.prev_label: int = blank_index
        self.beam_state = None
        self.feat_sum = 0.0
        self.feat_sumsq = 0.0
        self.feat_count = 0
        self.lock = threading.Lock()
        self.last_used = time.time()


class BatchWorker(threading.Thread):
    """Collects requests for up to batch_timeout_ms and runs them as one
    padded batch through the model."""

    def __init__(self, bundle: ModelBundle, decoder, cfg: ServerConfig):
        super().__init__(daemon=True)
        self.bundle = bundle
        self.decoder = decoder
        self.cfg = cfg
        self.extractor = FeatureExtractor(bundle.spect_cfg, normalize=True)
        # responses show only the top hypothesis: a beam decode backtracks
        # one char stream per utterance instead of beam_width of them
        self._n_best = 1
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.running = True
        self._sessions: dict = {}
        self._sessions_lock = threading.Lock()
        # long uploads run chunk by chunk here, so one long file never
        # stalls the batched short requests behind it
        self._long_pool = ThreadPoolExecutor(max_workers=2,
                                             thread_name_prefix="dsjax-torch-long")

    def submit(self, req: _Request) -> None:
        self.queue.put(req)

    def close(self) -> None:
        """Stop the batch loop and the side pool."""
        self.running = False
        if self.is_alive():
            self.join(timeout=5.0)
        self._long_pool.shutdown(wait=True)

    def warmup(self) -> None:
        """Run every power-of-two batch size once at warmup_seconds of audio,
        forward and decode, so no live request pays for first-use work (the
        kernel build, cuDNN algorithm choice, allocator growth, the loading
        of each CUDA kernel's module)."""
        secs = self.cfg.warmup_seconds
        if secs <= 0:
            return
        sr = self.bundle.spect_cfg.sample_rate
        spect = self.extractor(np.zeros(int(sr * secs), np.float32))
        max_t = _bucket(spect.shape[1])
        b = 1
        while b <= self.cfg.max_batch:
            inputs = np.zeros((b, spect.shape[0], max_t), np.float32)
            lengths = np.full((b,), spect.shape[1], np.int32)
            probs, out_lens, _ = self.bundle.forward(inputs, lengths)
            self.decoder.decode(probs, out_lens, n_best=self._n_best)
            b *= 2

    def run(self) -> None:
        while self.running:
            try:
                first = self.queue.get(timeout=0.25)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.cfg.batch_timeout_ms / 1000.0
            while len(batch) < self.cfg.max_batch and time.time() < deadline:
                try:
                    batch.append(self.queue.get(timeout=max(0.0, deadline - time.time())))
                except queue.Empty:
                    break
            self._process(batch)

    def _process(self, batch: List[_Request]) -> None:
        try:
            if self.cfg.chunk_size_seconds > 0:
                limit = self.cfg.chunk_size_seconds * self.bundle.spect_cfg.sample_rate
                long_reqs = [r for r in batch if len(r.audio) > limit]
                for r in long_reqs:
                    self._long_pool.submit(self._process_chunked, r)
                batch = [r for r in batch if r not in long_reqs]
                if not batch:
                    return
            spects = [self.extractor(r.audio) for r in batch]
            max_t = _bucket(max(s.shape[1] for s in spects))
            b_pad = 1
            while b_pad < len(batch):
                b_pad *= 2
            inputs = np.zeros((b_pad, spects[0].shape[0], max_t), np.float32)
            # padded rows get length 1, not 0; their outputs are sliced off
            lengths = np.ones((b_pad,), np.int32)
            for i, s in enumerate(spects):
                inputs[i, :, : s.shape[1]] = s
                lengths[i] = s.shape[1]
            probs, out_lens, _ = self.bundle.forward(inputs, lengths)
            decoded, offsets = self.decoder.decode(probs[: len(batch)],
                                                   out_lens[: len(batch)],
                                                   n_best=self._n_best)
            for i, req in enumerate(batch):
                req.result = decode_results([decoded[i]], [offsets[i]])
                req.event.set()
        except Exception as e:  # the batch's requests each get the error
            for req in batch:
                req.error = str(e)
                req.event.set()

    def stream_refusal(self) -> Optional[str]:
        """Why /stream cannot serve this model, or None."""
        if isinstance(getattr(self.bundle.model, "model_cfg", None), ConformerConfig):
            return ("/stream carries a recurrent model's state from chunk to chunk, and this "
                    "server's model (model=conformer) has none: post the whole file to "
                    "/transcribe")
        return None

    def stream_chunk(self, session_id: str, audio: np.ndarray, final: bool) -> dict:
        """Feed one audio chunk into a session; returns the transcript so
        far. The model (RNN carry) and the decoder (greedy collapse, or the
        beam search's carried state) are incremental, so a session's
        per-chunk work stays O(chunk). Raises ValueError for a model that
        cannot stream (``stream_refusal``)."""
        refusal = self.stream_refusal()
        if refusal:
            raise ValueError(refusal)
        blank = self.decoder.blank_index
        with self._sessions_lock:
            sess = self._sessions.setdefault(session_id, _StreamSession(blank))
            now = time.time()
            for sid in [s for s, v in self._sessions.items()
                        if now - v.last_used > self.cfg.stream_session_ttl
                        and s != session_id]:
                del self._sessions[sid]
        with sess.lock:
            sess.last_used = time.time()
            if len(audio):
                raw = spectrogram_np(audio, self.bundle.spect_cfg, normalize=False)
                sess.feat_sum += float(raw.astype(np.float64).sum())
                sess.feat_sumsq += float((raw.astype(np.float64) ** 2).sum())
                sess.feat_count += raw.size
                mean = sess.feat_sum / sess.feat_count
                # ddof=1 and the eps floor of spectrogram_np, so a one-chunk
                # session equals the one-shot /transcribe path
                var = max((sess.feat_sumsq - sess.feat_count * mean * mean)
                          / max(sess.feat_count - 1, 1), 0.0)
                std = max(np.sqrt(var), 1e-10)
                spect = ((raw - mean) / std)[None].astype(np.float32)
                t_true = spect.shape[2]
                spect = np.pad(spect, ((0, 0), (0, 0), (0, _bucket(t_true) - t_true)))
                probs, out_lens, sess.carry = self.bundle.forward(spect, [t_true],
                                                                  sess.carry)
                probs = probs[:, : int(out_lens[0])]
                if hasattr(self.decoder, "decode_chunk"):
                    sess.text, sess.beam_state = self.decoder.decode_chunk(
                        probs, sess.beam_state)
                else:
                    # the greedy decoder, or the host beam, which cannot
                    # stream and keeps its table in its label map
                    int_to_char = getattr(self.decoder, "int_to_char", None)
                    if int_to_char is None:
                        int_to_char = self.decoder.label_map.int_to_char
                    for lbl in probs[0].argmax(dim=-1).tolist():
                        if lbl != blank and lbl != sess.prev_label:
                            sess.text += int_to_char[lbl]
                        sess.prev_label = lbl
            out = {"transcription": sess.text, "final": final}
            if final:
                with self._sessions_lock:
                    self._sessions.pop(session_id, None)
            return out

    def _process_chunked(self, req: _Request) -> None:
        try:
            carry = None
            outs = []
            for chunk in self.extractor.chunks(req.audio, self.cfg.chunk_size_seconds):
                if len(chunk) == 0:
                    continue
                spect = self.extractor(chunk)[None]
                t_true = spect.shape[2]
                spect = np.pad(spect, ((0, 0), (0, 0), (0, _bucket(t_true) - t_true)))
                probs, out_lens, carry = self.bundle.forward(spect, [t_true], carry)
                outs.append(probs[:, : int(out_lens[0])])
            decoded, offsets = self.decoder.decode(torch.cat(outs, dim=1),
                                                   n_best=self._n_best)
            req.result = decode_results([decoded[0]], [offsets[0]])
        except Exception as e:
            req.error = str(e)
        req.event.set()


def make_handler(worker: BatchWorker, cfg: ServerConfig):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            sr = worker.bundle.spect_cfg.sample_rate
            if url.path == "/stream":
                refusal = worker.stream_refusal()
                if refusal:
                    self._send(400, {"error": refusal})
                    return
                q = parse_qs(url.query)
                session = (q.get("session") or ["default"])[0]
                final = (q.get("final") or ["0"])[0] in ("1", "true")
                _, payload = _parse_upload(ctype, data)
                audio = np.zeros((0,), np.float32)
                if payload:
                    try:
                        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                            f.write(payload)
                            f.flush()
                            audio = load_audio(f.name, sr)
                    except Exception as e:
                        self._send(400, {"error": f"could not decode audio: {e}"})
                        return
                try:
                    self._send(200, worker.stream_chunk(session, audio, final))
                except Exception as e:
                    self._send(500, {"error": str(e)})
                return
            if url.path != "/transcribe":
                self._send(404, {"error": "not found"})
                return
            filename, payload = _parse_upload(ctype, data)
            if payload is None:
                self._send(400, {"error": "expected multipart file upload or audio/wav body"})
                return
            ext = (filename or "upload.wav").rsplit(".", 1)[-1].lower()
            if ext in COMPRESSED_EXTENSIONS:
                if not native.can_decode(f"x.{ext}"):
                    self._send(415, {"error": f".{ext}: codec library not "
                                              f"available on this host"})
                    return
            elif ext not in ALLOWED_EXTENSIONS:
                self._send(415, {"error": f"unsupported extension .{ext}"})
                return
            try:
                if ext in COMPRESSED_EXTENSIONS:
                    audio, in_sr = native.decode_bytes(payload)
                    if in_sr != sr:
                        audio = np.ascontiguousarray(resample(audio, in_sr, sr), np.float32)
                else:
                    with tempfile.NamedTemporaryFile(suffix=f".{ext}") as f:
                        f.write(payload)
                        f.flush()
                        audio = load_audio(f.name, sr)
            except Exception as e:
                self._send(400, {"error": f"could not decode audio: {e}"})
                return
            req = _Request(audio)
            worker.submit(req)
            req.event.wait()
            if req.error:
                self._send(500, {"error": req.error})
            else:
                self._send(200, req.result)

    return Handler


def _parse_upload(content_type: str, data: bytes) -> Tuple[Optional[str], Optional[bytes]]:
    """Minimal multipart/form-data parser; also accepts raw audio bodies."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        if content_type.startswith("audio/") or content_type == "application/octet-stream":
            return "upload.wav", data
        return None, None
    boundary = ("--" + m.group(1)).encode()
    for part in data.split(boundary):
        if b"Content-Disposition" not in part:
            continue
        header, _, body = part.partition(b"\r\n\r\n")
        if b"filename=" not in header:
            continue
        fm = re.search(rb'filename="([^"]*)"', header)
        filename = fm.group(1).decode(errors="replace") if fm else "upload.wav"
        # each part ends with exactly the one CRLF before the next boundary
        if body.endswith(b"\r\n"):
            body = body[:-2]
        return filename, body
    return None, None


def serve(cfg: ServerConfig) -> Tuple[ThreadingHTTPServer, BatchWorker]:
    """Load the model, warm up, and start the batch worker and an HTTP server
    bound to (cfg.host, cfg.port); the server's loop runs on a daemon
    thread. Stop both with ``shutdown(server, worker)``."""
    bundle = load_model(cfg.model.model_path, cfg.model.precision, cfg.device,
                        cfg.num_cpu_devices)
    worker = BatchWorker(bundle, load_decoder(bundle.labels, cfg.lm), cfg)
    worker.warmup()
    worker.start()
    server = ThreadingHTTPServer((cfg.host, cfg.port), make_handler(worker, cfg))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, worker


def shutdown(server: ThreadingHTTPServer, worker: BatchWorker) -> None:
    server.shutdown()
    server.server_close()
    worker.close()


def main(cfg: ServerConfig) -> None:
    print("Setting up server...")
    server, worker = serve(cfg)
    print(f"Server initialised on {cfg.host}:{server.server_address[1]} ({cfg.device})")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        shutdown(server, worker)


if __name__ == "__main__":
    main(compose_cli(ServerConfig, __doc__, sys.argv[1:]))
