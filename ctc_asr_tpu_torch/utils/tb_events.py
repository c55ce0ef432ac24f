"""TensorBoard event-file writer — zero-dependency.

The port's own copy of ``ctc_asr_tpu/utils/tb_events.py``. The primary
metrics sink is the JSONL (metrics.py), but TB
event files remain the ecosystem-standard visualization format, so this
module writes them too — WITHOUT TensorFlow: the TFRecord framing
(length + masked CRC32C) and the Event/Summary protobuf wire encoding
are small enough to emit by hand (~100 lines).

Wire formats implemented:
- TFRecord: u64le(len) + u32le(maskedcrc(len_bytes)) + payload
  + u32le(maskedcrc(payload)); CRC32C (Castagnoli), masked per
  TensorFlow's ((crc >> 15 | crc << 17) + 0xa282ead8).
- Event proto: field 1 wall_time (double), 2 step (int64),
  3 file_version (string, first record only), 5 summary (message).
- Summary proto: repeated field 1 Value{tag=1 (string),
  simple_value=2 (float)}.

Verified against TensorBoard's own reader semantics in
tests/test_tb_events.py (hand-parses the records back, checks CRCs).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- CRC32C (Castagnoli, reflected polynomial 0x82F63B78) -----------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire encoding ----------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _summary(scalars: dict) -> bytes:
    out = b""
    for tag_name, value in scalars.items():
        val = (_field_bytes(1, tag_name.encode("utf-8"))
               + _field_float(2, float(value)))
        out += _field_bytes(1, val)
    return out


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    out = _field_double(1, wall_time)
    if step is not None:
        out += _field_varint(2, int(step))
    if file_version is not None:
        out += _field_bytes(3, file_version.encode("utf-8"))
    if scalars:
        out += _field_bytes(5, _summary(scalars))
    return out


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class EventFileWriter:
    """Append scalar summaries to a TensorBoard events file.

    Usage:
        w = EventFileWriter(log_dir)
        w.add_scalars(step=10, {"loss": 3.2, "wer": 0.4})
        w.close()
    """

    _seq = 0  # per-process uniquifier (same-second restarts must not
    # append to an existing file — 'ab' would interleave two runs)

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "host"
        EventFileWriter._seq += 1
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}"
                     f".{os.getpid()}.{EventFileWriter._seq}")
        self._fh = open(self.path, "ab", buffering=0)
        # TB requires a leading file_version event
        self._fh.write(_tfrecord(_event(time.time(),
                                        file_version="brain.Event:2")))

    def add_scalars(self, step: int, scalars: dict) -> None:
        numeric = {k: v for k, v in scalars.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        if not numeric:
            return
        self._fh.write(_tfrecord(_event(time.time(), step=step,
                                        scalars=numeric)))

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()
