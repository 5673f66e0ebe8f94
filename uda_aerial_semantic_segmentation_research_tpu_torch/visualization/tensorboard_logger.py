"""TensorBoard event logging without the ``tensorboard`` package.

Counterpart of the JAX package's ``TensorboardLogger``, which writes
through ``tensorboard``'s ``EventFileWriter``.  This module writes the same
files itself, so that the trainer runs where that package is not installed:

- the TFRecord framing of an event file: per record a little-endian
  uint64 length, its masked CRC-32C, the bytes, their masked CRC-32C;
- the protobuf wire format of ``Event`` / ``Summary`` for scalars
  (``simple_value``), images (PNG, encoded here with ``zlib``), histograms
  (``HistogramProto``, numpy's ``"auto"`` bins) and text (the ``text``
  plugin's string tensor);
- ``read_events`` parses such a file back, checking every CRC.

Surface: ``log_scalar`` / ``log_scalars`` / ``log_image`` (with the JAX
package's coercions: batch -> first element, CHW -> HWC, grayscale -> 3
channels, integer label maps scaled) / ``log_figure`` / ``log_histogram`` /
``log_text`` / ``flush`` / ``close``, one timestamped run directory per
logger.  ``log_figure`` takes the figure as an RGB uint8 array (the port
draws its figures in numpy: ``visualization.figures``), where the JAX
package takes a matplotlib figure.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import torch

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), as TFRecord framing needs it
# ---------------------------------------------------------------------------
_POLY = 0x82F63B78        # reflected Castagnoli polynomial


def _make_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_POLY), table >> 1)
    return table.astype(np.uint32)


_TABLE = _make_table()
_TABLE_LIST = _TABLE.tolist()
_LANES_MIN_BYTES = 32768  # below this the byte loop is faster than the lanes


def _apply(cols, x):
    """A GF(2)-linear map of 32-bit words, given by its 32 columns (the images
    of 1 << b), applied to ``x`` (an int or a uint32 array)."""
    if isinstance(x, np.ndarray):
        out = np.zeros_like(x)
        for b in range(32):
            out ^= np.where((x >> np.uint32(b)) & np.uint32(1), np.uint32(cols[b]),
                            np.uint32(0))
        return out
    out = 0
    for b in range(32):
        if (x >> b) & 1:
            out ^= cols[b]
    return out


def _zeros_operator(n: int):
    """Columns of the map ``s -> the CRC register after n zero bytes from s``."""
    one = [_TABLE_LIST[(1 << b) & 0xFF] ^ ((1 << b) >> 8) for b in range(32)]
    result = [1 << b for b in range(32)]                 # identity
    power = one
    while n:
        if n & 1:
            result = [_apply(power, c) for c in result]
        n >>= 1
        if n:
            power = [_apply(power, c) for c in power]
    return result


def _raw_crc_bytes(data: bytes, crc: int = 0) -> int:
    table = _TABLE_LIST
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _raw_crc_lanes(data: bytes) -> int:
    """The CRC register after ``data`` from 0 (no inversion).  The input is
    cut into 2^k lanes of equal length (zeros in front, which leave a register
    at 0 unchanged), run side by side with numpy, then folded pairwise:
    ``raw(A || B) = Z^len(B)(raw(A)) ^ raw(B)``, Z the zero-byte map."""
    n = len(data)
    lanes = 1 << min(12, (n // 256).bit_length() - 1)
    length = -(-n // lanes)
    buf = np.zeros(lanes * length, dtype=np.uint8)
    buf[lanes * length - n:] = np.frombuffer(data, dtype=np.uint8)
    rows = buf.reshape(lanes, length).T.astype(np.uint32)   # (length, lanes)
    crc = np.zeros(lanes, dtype=np.uint32)
    for row in rows:
        crc = _TABLE[(crc ^ row) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    shift = _zeros_operator(length)
    while len(crc) > 1:
        crc = _apply(shift, crc[0::2]) ^ crc[1::2]
        shift = [_apply(shift, c) for c in shift]              # twice as long
    return int(crc[0])


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (initial register and final value inverted)."""
    if len(data) < _LANES_MIN_BYTES:
        return _raw_crc_bytes(data, 0xFFFFFFFF) ^ 0xFFFFFFFF
    inverted = _apply(_zeros_operator(len(data)), 0xFFFFFFFF)
    return (inverted ^ _raw_crc_lanes(data)) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                 # negative int64: two's complement
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(int(n))


def _double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(x))


def _float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(x))


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _packed_doubles(field: int, values) -> bytes:
    return _bytes(field, np.asarray(values, dtype="<f8").tobytes())


def _event(wall_time: float, step: int = 0, summary: bytes | None = None,
           file_version: str | None = None) -> bytes:
    out = _double(1, wall_time) + _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def _summary_value(tag: str, body: bytes) -> bytes:
    """``Summary`` holding one ``Summary.Value`` (tag plus ``body`` fields)."""
    return _bytes(1, _bytes(1, tag.encode()) + body)


def _fields(buf: bytes):
    """(field, wire type, value) of a protobuf message; value is an int for
    varints, bytes for fixed64 / fixed32 / length-delimited fields."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, i: int):
    shift = result = 0
    while True:
        byte = buf[i]
        i += 1
        result |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return result, i


def read_events(path):
    """The events of one event file as dicts (``wall_time``, ``step`` and,
    per summary value, ``values``: ``{"tag", "kind", "value"}`` with kind
    ``scalar`` / ``image`` / ``histogram`` / ``tensor``).  Raises ValueError
    on a record whose length or data CRC does not match."""
    data = Path(path).read_bytes()
    events, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"bad length CRC at byte {i} of {path}")
        body = data[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if len(body) != n or crc != masked_crc32c(body):
            raise ValueError(f"bad data CRC at byte {i} of {path}")
        i += 16 + n
        event = {"wall_time": 0.0, "step": 0, "values": []}
        for field, _, value in _fields(body):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif field == 2:
                event["step"] = value - (1 << 64) if value >> 63 else value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                for _, _, v in _fields(value):
                    event["values"].append(_decode_value(v))
        events.append(event)
    return events


def _decode_value(buf: bytes) -> dict:
    out = {}
    for field, _, value in _fields(buf):
        if field == 1:
            out["tag"] = value.decode()
        elif field == 2:
            out["kind"], out["value"] = "scalar", struct.unpack("<f", value)[0]
        elif field == 4:
            out["kind"], out["value"] = "image", dict(
                (f, v) for f, _, v in _fields(value))
        elif field == 5:
            out["kind"], out["value"] = "histogram", dict(
                (f, v) for f, _, v in _fields(value))
        elif field == 8:
            out["kind"], out["value"] = "tensor", value
    return out


# ---------------------------------------------------------------------------
# PNG (zlib) and the image coercions
# ---------------------------------------------------------------------------
def encode_png(img_u8: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) gray -> PNG bytes (no row filter)."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _coerce_image(image) -> np.ndarray:
    """Any array-ish image -> uint8 (H, W, 3), as the JAX package coerces:
    batched -> first element; CHW -> HWC; grayscale -> 3 channels; integer
    label maps -> scaled by their maximum; floats assumed in [0, 1] unless
    their range says otherwise."""
    arr = _host_array(image)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)

    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.float32)
        vmax = max(float(arr.max()), 1.0)
        arr = arr / vmax
    else:
        arr = arr.astype(np.float32)
        lo, hi = float(arr.min()), float(arr.max())
        if hi > 1.0 + 1e-3 or lo < -1e-3:  # normalized/denormalized floats
            arr = (arr - lo) / max(hi - lo, 1e-6)
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


_UID = itertools.count()


class TensorboardLogger:
    """Writes scalars/images/figures/histograms/text to a timestamped run dir."""

    def __init__(self, log_dir: str = "logs"):
        timestamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
        self.log_dir = Path(log_dir) / timestamp
        self.log_dir.mkdir(parents=True, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
                f".{os.getpid()}.{next(_UID)}")
        self.path = self.log_dir / name
        self._file = open(self.path, "wb")
        self._closed = False
        self._file.write(_record(_event(time.time(), file_version="brain.Event:2")))
        self._file.flush()

    # ------------------------------------------------------------------
    def _emit(self, summary: bytes, step: int):
        if self._closed:
            # trainers close their logger at the end of train() but stay
            # usable for validate(): late events are dropped
            return
        self._file.write(_record(_event(time.time(), int(step), summary)))

    def log_scalar(self, tag: str, value, step: int):
        self._emit(_summary_value(tag, _float(2, float(_host_array(value)))), step)

    def log_scalars(self, main_tag: str, tag_scalar_dict: dict, step: int):
        """Log a group of scalars as ``main_tag/<name>`` values."""
        for k, v in tag_scalar_dict.items():
            self.log_scalar(f"{main_tag}/{k}", v, step)

    def _log_png(self, tag: str, img: np.ndarray, step: int):
        h, w = img.shape[:2]
        image = _int(1, h) + _int(2, w) + _int(3, 3) + _bytes(4, encode_png(img))
        self._emit(_summary_value(tag, _bytes(4, image)), step)

    def log_image(self, tag: str, image, step: int):
        self._log_png(tag, _coerce_image(image), step)

    def log_figure(self, tag: str, figure: np.ndarray, step: int):
        """``figure``: the drawn figure as a uint8 (H, W, 3) RGB array."""
        figure = np.asarray(figure)
        if figure.dtype != np.uint8 or figure.ndim != 3 or figure.shape[-1] != 3:
            raise ValueError(f"a figure is a uint8 (H, W, 3) array, got "
                             f"{figure.dtype} {figure.shape}")
        self._log_png(tag, figure, step)

    def log_histogram(self, tag: str, values, step: int, bins="auto"):
        v = _host_array(values).reshape(-1).astype(np.float64)
        counts, edges = np.histogram(v, bins=bins)
        histo = (_double(1, v.min()) + _double(2, v.max()) + _double(3, v.size)
                 + _double(4, v.sum()) + _double(5, (v * v).sum())
                 + _packed_doubles(6, edges[1:]) + _packed_doubles(7, counts))
        self._emit(_summary_value(tag, _bytes(5, histo)), step)

    def log_text(self, tag: str, text: str, step: int = 0):
        metadata = _bytes(1, _bytes(1, b"text"))               # plugin_data.plugin_name
        tensor = (_int(1, 7)                                    # DT_STRING
                  + _bytes(2, _bytes(2, _int(1, 1)))            # shape [1]
                  + _bytes(8, text.encode("utf-8")))
        self._emit(_summary_value(f"{tag}/text_summary",
                                  _bytes(9, metadata) + _bytes(8, tensor)), step)

    def flush(self):
        if not self._closed:
            self._file.flush()

    def close(self):
        if not self._closed:
            self._closed = True
            self._file.close()
