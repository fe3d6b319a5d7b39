"""Metric sinks: one JSON record a line in `<workdir>/metrics.jsonl`, and
with `tensorboard=True` TensorBoard scalars in `<workdir>/tb` (the port's
copy of the JAX package's utils/metrics_writer.py).

Replaces the reference's tensorboardX SummaryWriter usage
(learnGeodesicBDModel.py:99,136-137,187-194): the same scalar names
(train_loss, alpha, val_loss) are written. The event file is written by
hand, with no TensorBoard or TensorFlow package: TFRecord framing (length,
its masked CRC32C, the record, its masked CRC32C) around serialized
`Event` protos: a first `file_version` event, then one
Event{wall_time, step, summary{value{tag, simple_value}}} a record.
TensorBoard and `tf.compat.v1.train.summary_iterator` read it.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from pathlib import Path

# --- CRC32C (Castagnoli) and the TFRecord framing --------------------------------


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add 0xa282ead8."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def read_tfrecords(path: str | Path) -> list[bytes]:
    """The records of a TFRecord file, each CRC checked (raises on a bad one)."""
    buf, out, i = Path(path).read_bytes(), [], 0
    while i < len(buf):
        (n,) = struct.unpack_from("<Q", buf, i)
        if struct.unpack_from("<I", buf, i + 8)[0] != masked_crc32c(buf[i:i + 8]):
            raise ValueError(f"bad length CRC at byte {i} of {path}")
        data = buf[i + 12:i + 12 + n]
        if struct.unpack_from("<I", buf, i + 12 + n)[0] != masked_crc32c(data):
            raise ValueError(f"bad data CRC at byte {i} of {path}")
        out.append(data)
        i += 16 + n
    return out


# --- the protobuf wire format of Event and Summary -------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 as two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _bytes_field(num: int, data: bytes) -> bytes:
    return _field(num, 2, _varint(len(data)) + data)


def event_bytes(wall_time: float, step: int = 0, scalars: dict | None = None,
                file_version: str | None = None) -> bytes:
    """A serialized tensorflow.Event: wall_time (1, double), step (2,
    int64), file_version (3, string) or summary (5) of Summary.Value
    entries (1) with tag (1, string) and simple_value (2, float)."""
    msg = _field(1, 1, struct.pack("<d", wall_time)) + _field(2, 0, _varint(int(step)))
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if scalars:
        values = b"".join(
            _bytes_field(1, _bytes_field(1, str(tag).encode())
                         + _field(2, 5, struct.pack("<f", float(v))))
            for tag, v in scalars.items())
        msg += _bytes_field(5, values)
    return msg


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        n |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, v


def read_scalars(path: str | Path) -> list[tuple[str, int, float]]:
    """(tag, step, simple_value) of every scalar in an event file, in order."""
    out = []
    for rec in read_tfrecords(path):
        step, values = 0, []
        for num, _, v in _fields(rec):
            if num == 2:
                step = v - (1 << 64) if v >= 1 << 63 else v
            elif num == 5:
                for vnum, _, value in _fields(v):
                    if vnum == 1:
                        f = dict((n, x) for n, _, x in _fields(value))
                        values.append((f[1].decode(), struct.unpack("<f", f[2])[0]))
        out += [(tag, step, val) for tag, val in values]
    return out


class _EventFile:
    """An appending TensorBoard event file in `logdir`."""

    def __init__(self, logdir: Path):
        logdir.mkdir(parents=True, exist_ok=True)
        self.path = logdir / (f"events.out.tfevents.{int(time.time())}."
                              f"{socket.gethostname()}.{os.getpid()}")
        with open(self.path, "ab") as f:
            f.write(tfrecord(event_bytes(time.time(), file_version="brain.Event:2")))

    def write(self, step: int, scalars: dict) -> None:
        with open(self.path, "ab") as f:
            f.write(tfrecord(event_bytes(time.time(), step, scalars)))


class MetricsWriter:
    def __init__(self, workdir: str | Path, tensorboard: bool = False):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.path = self.workdir / "metrics.jsonl"
        self._tb = _EventFile(self.workdir / "tb") if tensorboard else None

    def write(self, step: int, scalars: dict) -> None:
        """Append {"step": step, **scalars} as one line (and, with
        TensorBoard on, one event of the same scalars). The files are opened
        for each record, so a record is on disk when write returns and no
        handle outlives the call."""
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.write(int(step), scalars)
