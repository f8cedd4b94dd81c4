"""Observability: metrics logging and step timing, a copy of
dsjax/train/logging.py.

  * MetricsLogger: a JSONL scalar stream (one line per event) plus
    TensorBoard event files, the counterpart of Lightning's default
    TensorBoardLogger in the reference (configs/lightning_config.py:28-51).
  * TFEventWriter: a minimal tfevents scalar writer (no tensorflow import).
  * StepTimer: per-step wall timing with utterances per second.
  * profile_steps: a torch.profiler trace of the enclosed steps, written as
    one Chrome trace file (``trainer.profile``; dsjax writes an XProf trace
    with jax.profiler).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import struct
import time
from typing import Any, Dict, Iterator, Optional

import torch

# ---------------------------------------------------------------------------
# Minimal tfevents writer (TFRecord framing + hand-encoded Event protos).
# The wire format is tiny and frozen: records are
#   uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)
# and a scalar Event proto is three fields (wall_time, step, summary).
# Writing it directly avoids importing tensorflow/tensorboard (multi-second
# import, absl logging side effects) in the training process.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), reflected polynomial 0x82F63B78."""
    global _CRC_TABLE
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:
        # proto varints encode negative int64 as 10-byte two's complement;
        # without the mask `n >>= 7` never reaches 0 and this loops forever.
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _scalar_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    val = (_pb_bytes(1, tag.encode()) +
           _varint(2 << 3 | 5) + struct.pack("<f", value))
    summary = _pb_bytes(1, val)
    # Event { wall_time = 1 (double); step = 2 (int64); summary = 5 }
    return (_varint(1 << 3 | 1) + struct.pack("<d", wall_time) +
            _varint(2 << 3) + _varint(step) +
            _pb_bytes(5, summary))


class TFEventWriter:
    """Append-only tfevents scalar writer (TensorBoard-compatible)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
        self._fh = open(self.path, "ab")
        # Event { file_version = 3 (string) } header record
        self._write(_varint(1 << 3 | 1) + struct.pack("<d", time.time()) +
                    _pb_bytes(3, b"brain.Event:2"))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._fh.write(header + struct.pack("<I", _masked_crc(header)) +
                       event + struct.pack("<I", _masked_crc(event)))
        self._fh.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_scalar_event(step, tag, value, time.time()))

    def close(self) -> None:
        self._fh.close()


class MetricsLogger:
    """JSONL scalar stream + TensorBoard event files.

    Reference parity: Lightning's default TensorBoardLogger with
    log_every_n_steps (configs/lightning_config.py:28-51). Every ``log``
    call appends one JSONL row and one tfevents scalar per metric.
    """

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", buffering=1)
        self._tb = TFEventWriter(log_dir)

    def log(self, step: int, **scalars: float) -> None:
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        for k, v in scalars.items():
            self._tb.scalar(k, float(v), int(step))

    def close(self) -> None:
        self._fh.close()
        self._tb.close()


@contextlib.contextmanager
def profile_steps(log_dir: str) -> Iterator[None]:
    """Trace the enclosed steps with torch.profiler (the host and, where a
    card is present, its kernels) and write one Chrome trace,
    ``log_dir/<host>.<pid>.<ns>.pt.trace.json``, when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


class StepTimer:
    """Rolling step timing; call tick(batch_size) after each blocked step."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self.items = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, batch_size: int) -> Optional[float]:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        self.items.append(batch_size)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.items.pop(0)
        return dt

    @property
    def utterances_per_sec(self) -> float:
        total = sum(self.times)
        return sum(self.items) / total if total > 0 else 0.0
