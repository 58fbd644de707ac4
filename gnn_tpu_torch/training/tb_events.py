"""Pure-Python TensorBoard event-file writer (counterpart of
gnn_tpu/training/tb_events.py): for the same scalars, histograms and wall
times it writes the same bytes.

Records are TFRecord-framed (little-endian uint64 length, masked CRC32C of
the length, payload, masked CRC32C of the payload); payloads are
hand-encoded `tensorflow.Event` protobufs carrying `file_version` (the
first record), a scalar `Summary.Value.simple_value` or a legacy
`HistogramProto`, which TensorBoard reads natively. No TensorFlow is needed.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Sequence

import numpy as np

# ------------------------------------------------------------------- crc32c
# Castagnoli CRC (poly 0x82F63B78, reflected), table-driven. TFRecord masks
# the CRC by rotating right 15 bits and adding a constant.
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------- protobuf encode
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _packed_f64(field: int, vals: Sequence[float]) -> bytes:
    return _bytes_field(field, struct.pack(f"<{len(vals)}d", *vals))


def _histogram_proto(values: np.ndarray) -> bytes:
    """Legacy HistogramProto from raw values (event.proto: min=1 max=2 num=3
    sum=4 sum_squares=5, packed bucket_limit=6 / bucket=7)."""
    v = np.asarray(values, dtype=np.float64).ravel()
    if v.size == 0:
        v = np.zeros(1)
    lo, hi = float(v.min()), float(v.max())
    if lo == hi:  # degenerate: one bucket around the constant
        limits = [lo + 1e-12]
        counts = [float(v.size)]
    else:
        edges = np.linspace(lo, hi, 31)
        counts = np.histogram(v, bins=edges)[0].astype(np.float64)
        limits = edges[1:].tolist()
        counts = counts.tolist()
    return (_f64(1, lo) + _f64(2, hi) + _f64(3, float(v.size))
            + _f64(4, float(v.sum())) + _f64(5, float(np.square(v).sum()))
            + _packed_f64(6, limits) + _packed_f64(7, counts))


def _event(step: int = None, summary: bytes = None, file_version: str = None,
           wall_time: float = None) -> bytes:
    """Event proto (event.proto: wall_time=1 step=2 file_version=3 summary=5)."""
    out = _f64(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value (summary.proto: tag=1 simple_value=2)."""
    return _bytes_field(1, _bytes_field(1, tag.encode()) + _f32(2, float(value)))


def _histo_value(tag: str, values) -> bytes:
    """Summary.Value with legacy histo (summary.proto: tag=1 histo=5)."""
    return _bytes_field(1, _bytes_field(1, tag.encode())
                        + _bytes_field(5, _histogram_proto(values)))


# --------------------------------------------------------------- the writer
class TBEventFile:
    """One TensorBoard run directory holding one event file; scalars are
    tagged "<scope>/<name>" as tf.name_scope(scope) + tf.summary.scalar(name)
    tag them."""

    _seq = 0  # per-process uniquifier: second-resolution timestamps collide

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        TBEventFile._seq += 1
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.{TBEventFile._seq}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "wb")
        self._record(_event(file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(step=step, summary=_scalar_value(tag, value)))

    def histogram(self, tag: str, values, step: int) -> None:
        self._record(_event(step=step, summary=_histo_value(tag, values)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __del__(self):  # best-effort: event files must survive interpreter exit
        try:
            self.close()
        except Exception:
            pass
