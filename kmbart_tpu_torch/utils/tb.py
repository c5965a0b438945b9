"""Minimal TensorBoard event-file writer (no tensorboard/protobuf deps).

Parity target: the reference's ``SummaryWriter`` scalar logging
(pretrain.py:45, src/training.py:72-79,92-93, src/validation.py:120,161-163).
Writes standard ``events.out.tfevents.*`` files readable by TensorBoard:
length-prefixed records with masked CRC32C, containing hand-encoded Event
protos (wall_time/step/summary{tag, simple_value}).
"""

import os
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire-format helpers
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field_varint(num, n):
    return _varint((num << 3) | 0) + _varint(n)


def _field_double(num, x):
    return _varint((num << 3) | 1) + struct.pack("<d", x)


def _field_float(num, x):
    return _varint((num << 3) | 5) + struct.pack("<f", x)


def _field_bytes(num, data):
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def _event(wall_time, step=None, file_version=None, summary=None):
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag, value):
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


class SummaryWriter:
    """Scalar-only TensorBoard writer: add_scalar / add_scalars / flush."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.{}.{}".format(int(time.time()), os.getpid())
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event_bytes):
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))

    def add_scalar(self, tag, value, step):
        self._write(_event(time.time(), step=int(step),
                           summary=_scalar_summary(tag, value)))

    def add_scalars(self, main_tag, tag_value_dict, step):
        """torch SummaryWriter.add_scalars look-alike (one tag per key)."""
        for k, v in tag_value_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
