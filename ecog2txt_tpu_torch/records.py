"""TFRecord-compatible storage: container framing + Example proto codec.

The reference's L2↔L5 data contract is "one TFRecord file per block, one
``tf.train.Example`` per trial" (written via
``tf.io.TFRecordWriter`` + ``tfh.make_feature_example`` at
data_generators.py:317-326).  This module reimplements that contract
**without TensorFlow**:

* the TFRecord on-disk framing (little-endian u64 length, masked-CRC32C
  of the length, payload, masked-CRC32C of the payload), and
* a minimal protobuf wire-format codec for ``tf.train.Example``
  (Example{1: Features{1: map<string, Feature{1: BytesList | 2:
  FloatList | 3: Int64List}>}}; float/int lists packed).

Float sequences are stored **flattened** (T·C float32) and reshaped on
parse using the manifest's ``num_features_raw`` (reference
trainers.py:864-866) — preserved here so files interop byte-for-byte
with the reference toolchain (validated in tests against TF itself).

CRC32C runs through the C++ ``libfastio`` extension (SSE4.2 hardware
CRC) when built, with a pure-Python table fallback.

The port's own copy of ``ecog2txt_tpu/records.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import warnings
from typing import Any, Iterator

import numpy as np

# --------------------------------------------------------------------------
# CRC32C — native fast path + python fallback
# --------------------------------------------------------------------------

# built into the package's _build/ (listed in .gitignore) from the
# repository's native/fastio.cpp, which is read, not copied
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_NATIVE_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "fastio.cpp",
)
_lib = None


def _build_native() -> str | None:
    """Compile libfastio.so on demand (g++, -msse4.2 when supported)."""
    if not os.path.exists(_NATIVE_SRC):
        return None
    os.makedirs(_NATIVE_DIR, exist_ok=True)
    so_path = os.path.join(_NATIVE_DIR, "libfastio.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(
        _NATIVE_SRC
    ):
        return so_path
    for extra in (["-msse4.2"], []):
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", *extra, _NATIVE_SRC, "-o", so_path,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            return so_path
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            continue
    return None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    so_path = _build_native()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(so_path)
        lib.fastio_crc32c.restype = ctypes.c_uint32
        lib.fastio_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.fastio_masked_crc32c.restype = ctypes.c_uint32
        lib.fastio_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fastio_tfrecord_index2.restype = ctypes.c_long
        lib.fastio_tfrecord_index2.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            u64p, u64p, ctypes.c_long,
        ]
        lib.fastio_example_index.restype = ctypes.c_long
        lib.fastio_example_index.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            u64p, u64p, ctypes.POINTER(ctypes.c_int32), u64p, u64p,
            ctypes.c_long,
        ]
        lib.fastio_decode_floats.restype = ctypes.c_long
        lib.fastio_decode_floats.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.fastio_decode_int64s.restype = ctypes.c_long
        lib.fastio_decode_int64s.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ]
        _lib = lib
        return lib
    except OSError as e:  # pragma: no cover
        warnings.warn(f"libfastio unavailable ({e}); using python CRC32C")
        return None


def _make_crc_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    lib = _load_native()
    if lib is not None:
        return lib.fastio_crc32c(data, len(data))
    return _crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------------
# TFRecord container framing
# --------------------------------------------------------------------------


class TFRecordWriter:
    """Append serialized payloads to a TFRecord file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tfrecord_iterator(path: str, verify: bool = False) -> Iterator[bytes]:
    """Yield record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, n = 0, len(data)
    while pos < n:
        if pos + 12 > n:
            raise IOError(f"truncated record header at byte {pos} of {path}")
        (length,) = struct.unpack_from("<Q", data, pos)
        payload_start = pos + 12
        payload_end = payload_start + length
        if payload_end + 4 > n:
            raise IOError(f"truncated record payload at byte {pos} of {path}")
        payload = data[payload_start:payload_end]
        if verify:
            (hdr_crc,) = struct.unpack_from("<I", data, pos + 8)
            (pay_crc,) = struct.unpack_from("<I", data, payload_end)
            if masked_crc32c(data[pos : pos + 8]) != hdr_crc:
                raise IOError(f"header CRC mismatch at byte {pos} of {path}")
            if masked_crc32c(payload) != pay_crc:
                raise IOError(f"payload CRC mismatch at byte {pos} of {path}")
        yield payload
        pos = payload_end + 4


# --------------------------------------------------------------------------
# protobuf wire helpers
# --------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


# --------------------------------------------------------------------------
# tf.train.Example codec
# --------------------------------------------------------------------------


def _encode_feature(value: Any) -> bytes:
    """One Feature message.  numpy float arrays → FloatList (flattened,
    packed f32); str/bytes (or lists thereof) → BytesList; integer arrays
    → Int64List (packed)."""
    if isinstance(value, (str, bytes)):
        value = [value]
    if isinstance(value, np.ndarray) and value.dtype.kind in "fc":
        packed = np.ascontiguousarray(value, dtype="<f4").tobytes()
        inner = _length_delimited(1, packed) if packed else _tag(1, 2) + _varint(0)
        return _length_delimited(2, inner)  # Feature.float_list = 2
    if isinstance(value, np.ndarray) and value.dtype.kind in "iu":
        packed = b"".join(
            _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in value.flatten()
        )
        inner = _length_delimited(1, packed)
        return _length_delimited(3, inner)  # Feature.int64_list = 3
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, (str, bytes)) for v in value):
            inner = b"".join(
                _length_delimited(
                    1, v.encode("utf-8") if isinstance(v, str) else v
                )
                for v in value
            )
            return _length_delimited(1, inner)  # Feature.bytes_list = 1
        if all(isinstance(v, (int, np.integer)) for v in value):
            return _encode_feature(np.asarray(value, dtype=np.int64))
        return _encode_feature(np.asarray(value, dtype=np.float32))
    if isinstance(value, (float, np.floating)):
        return _encode_feature(np.asarray([value], dtype=np.float32))
    if isinstance(value, (int, np.integer)):
        return _encode_feature(np.asarray([value], dtype=np.int64))
    raise TypeError(f"cannot encode feature of type {type(value)}")


def encode_example(features: dict[str, Any]) -> bytes:
    """dict → serialized ``tf.train.Example`` (the reference's
    ``tfh.make_feature_example``).  Float arrays are flattened — shape
    restoration is the parser's job, via the data manifest."""
    entries = b"".join(
        _length_delimited(
            1,
            _length_delimited(1, name.encode("utf-8"))
            + _length_delimited(2, _encode_feature(value)),
        )
        for name, value in sorted(features.items())
    )
    return _length_delimited(1, entries)  # Example.features = 1


def _decode_float_list(buf: bytes) -> np.ndarray:
    values, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed
            n, pos = _read_varint(buf, pos)
            values.append(np.frombuffer(buf, dtype="<f4", count=n // 4, offset=pos))
            pos += n
        elif field == 1 and wire == 5:  # unpacked fixed32
            values.append(np.frombuffer(buf, dtype="<f4", count=1, offset=pos))
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)
    if not values:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate(values)


def _decode_int64_list(buf: bytes) -> np.ndarray:
    values, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed
            n, pos = _read_varint(buf, pos)
            end = pos + n
            while pos < end:
                v, pos = _read_varint(buf, pos)
                values.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif field == 1 and wire == 0:
            v, pos = _read_varint(buf, pos)
            values.append(v - (1 << 64) if v >= (1 << 63) else v)
        else:
            pos = _skip_field(buf, pos, wire)
    return np.asarray(values, dtype=np.int64)


def _decode_bytes_list(buf: bytes) -> list[bytes]:
    values, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            values.append(buf[pos : pos + n])
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return values


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise IOError(f"unsupported wire type {wire}")
    return pos


def _decode_feature(buf: bytes) -> np.ndarray | list[bytes]:
    """Feature message → decoded value list.  A list field serialized as
    multiple occurrences (legal protobuf merge encoding) concatenates —
    the same semantics the native reader falls back to this decoder
    for."""
    parts: list = []
    kind = None
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2 or field not in (1, 2, 3):
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        inner = buf[pos : pos + n]
        pos += n
        if kind is None:
            kind = field
        elif field != kind:  # conflicting kinds: keep the first
            continue
        if field == 1:
            parts.append(_decode_bytes_list(inner))
        elif field == 2:
            parts.append(_decode_float_list(inner))
        else:
            parts.append(_decode_int64_list(inner))
    if not parts:
        return np.zeros(0, dtype=np.float32)
    if kind == 1:
        return [b for p in parts for b in p]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def parse_example(payload: bytes) -> dict[str, np.ndarray | list[bytes]]:
    """Serialized Example → {name: float32 array | int64 array |
    list[bytes]}.  Float arrays come back flattened, as stored."""
    out: dict[str, Any] = {}
    pos = 0
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1 or wire != 2:
            pos = _skip_field(payload, pos, wire)
            continue
        n, pos = _read_varint(payload, pos)
        features_buf = payload[pos : pos + n]
        pos += n
        fpos = 0
        while fpos < len(features_buf):
            ftag, fpos = _read_varint(features_buf, fpos)
            ffield, fwire = ftag >> 3, ftag & 7
            if ffield != 1 or fwire != 2:
                fpos = _skip_field(features_buf, fpos, fwire)
                continue
            entry_len, fpos = _read_varint(features_buf, fpos)
            entry = features_buf[fpos : fpos + entry_len]
            fpos += entry_len
            key, value = None, None
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                efield, ewire = etag >> 3, etag & 7
                if ewire != 2:
                    epos = _skip_field(entry, epos, ewire)
                    continue
                elen, epos = _read_varint(entry, epos)
                body = entry[epos : epos + elen]
                epos += elen
                if efield == 1:
                    key = body.decode("utf-8")
                elif efield == 2:
                    value = _decode_feature(body)
            if key is not None:
                out[key] = value
    return out


def read_examples(path: str) -> Iterator[dict[str, Any]]:
    """Parse every Example in a TFRecord file.

    Large records (ECoG trials: 100 KB–2 MB of packed floats) go through
    the native C++ reader — measured ~2× the Python decoder WITH CRC
    verification on (which the Python default path skips).  Tiny records
    stay on the Python decoder, whose per-record overhead is lower than
    the ctypes round trips (measured crossover ≈ 4 KB; the first
    record's length is the dispatch proxy — record sizes within a file
    are homogeneous here).  Both produce identical structures (tested).
    """
    lib = _load_native()
    if lib is not None:
        try:
            with open(path, "rb") as f:
                head = f.read(8)
            first_len = struct.unpack("<Q", head)[0] if len(head) == 8 else 0
        except OSError:
            first_len = 0
        if first_len >= 4096:
            yield from read_examples_native(path, lib=lib)
            return
    # small-record fallback: CRC-verify whenever the native CRC32C is
    # available (near-free); with no native lib at all, verification is
    # skipped here — pure-python CRC over a whole file is slower than
    # the decode itself (use tfrecord_iterator(path, verify=True) to
    # force it).
    for payload in tfrecord_iterator(path, verify=_load_native() is not None):
        yield parse_example(payload)


_MAX_FEATURES = 256


def read_examples_native(
    path: str, verify: bool = True, lib=None
) -> Iterator[dict[str, Any]]:
    """Native-decoded Example stream (the production data-loader path):
    one C call indexes and CRC-verifies the whole file's framing, then
    per record one C call indexes the feature table and one C call per
    numeric feature decodes straight into a numpy buffer — no
    per-varint Python."""
    lib = lib or _load_native()
    if lib is None:  # pragma: no cover - depends on toolchain
        yield from (
            parse_example(p) for p in tfrecord_iterator(path, verify=verify)
        )
        return
    with RecordFile(path, verify=verify) as rf:
        for i in range(len(rf)):
            yield rf.example(i)


def _decode_example_native(lib, mm, base, off, length, path):
    """Decode ONE Example record at (off, length) in an mmap'd file via
    the native feature-table indexer; falls back to the Python decoder
    for records outside the indexer's fast shape."""
    koff = np.empty(_MAX_FEATURES, dtype=np.uint64)
    klen = np.empty(_MAX_FEATURES, dtype=np.uint64)
    kinds = np.empty(_MAX_FEATURES, dtype=np.int32)
    voff = np.empty(_MAX_FEATURES, dtype=np.uint64)
    vlen = np.empty(_MAX_FEATURES, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nfeat = lib.fastio_example_index(
        ctypes.c_void_p(base + off), length,
        koff.ctypes.data_as(u64p), klen.ctypes.data_as(u64p),
        kinds.ctypes.data_as(i32p),
        voff.ctypes.data_as(u64p), vlen.ctypes.data_as(u64p),
        _MAX_FEATURES,
    )
    if nfeat in (-2, -3):
        # valid but outside the indexer's fast shape (>_MAX_FEATURES
        # features, or a list field split across occurrences): full
        # Python decode for this record
        return parse_example(bytes(mm[off : off + length]))
    if nfeat < 0:
        raise IOError(f"{path}: malformed Example record")
    out: dict[str, Any] = {}
    for k in range(nfeat):
        a = off + int(koff[k])
        key = bytes(mm[a : a + int(klen[k])]).decode("utf-8")
        vo, vl = off + int(voff[k]), int(vlen[k])
        kind = int(kinds[k])
        if kind == 2:  # float_list: ≤ vl/4 packed floats
            arr = np.empty(vl // 4 + 1, dtype=np.float32)
            n = lib.fastio_decode_floats(
                ctypes.c_void_p(base + vo), vl,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(arr),
            )
            if n < 0:
                raise IOError(f"{path}: bad float list {key!r}")
            out[key] = arr[:n]
        elif kind == 3:  # int64_list: ≤ vl packed varints
            arr = np.empty(vl + 1, dtype=np.int64)
            n = lib.fastio_decode_int64s(
                ctypes.c_void_p(base + vo), vl,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(arr),
            )
            if n < 0:
                raise IOError(f"{path}: bad int64 list {key!r}")
            out[key] = arr[:n]
        elif kind == 1:  # bytes_list: decoded in Python (small)
            out[key] = _decode_bytes_list(bytes(mm[vo : vo + vl]))
        else:  # empty Feature{} — match the Python decoder
            out[key] = np.zeros(0, dtype=np.float32)
    return out



class RecordFile:
    """Random-access TFRecord file: ONE framing (+CRC) index pass up
    front, then :meth:`example`(i) decodes a single record on demand.

    This is the primitive under the lazy host data pipeline (VERDICT r2
    #4): payloads live in an mmap and are only touched when decoded, so
    holding a RecordFile open costs O(index) host memory — a shard
    loader can re-read exactly the trials it needs at native speed
    instead of materializing the whole corpus.

    Uses the native fastio indexer/decoder when available; otherwise a
    Python framing walk + Python Example decode (identical results,
    tested)."""

    def __init__(self, path: str, verify: bool = True):
        self._path = path
        self._lib = _load_native()
        self._f = open(path, "rb")
        try:
            import mmap as _mmap

            self._mm = _mmap.mmap(
                self._f.fileno(), 0, access=_mmap.ACCESS_READ
            )
        except ValueError:  # zero-length file
            self._mm = None
            self._offsets = np.zeros(0, np.uint64)
            self._lengths = np.zeros(0, np.uint64)
            return
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        self._base = self._buf.ctypes.data
        total = len(self._buf)
        if self._lib is not None:
            cap = total // 16 + 1  # every record is ≥ 16 framing bytes
            offsets = np.empty(cap, dtype=np.uint64)
            lengths = np.empty(cap, dtype=np.uint64)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            count = self._lib.fastio_tfrecord_index2(
                ctypes.c_void_p(self._base), total, int(verify),
                offsets.ctypes.data_as(u64p),
                lengths.ctypes.data_as(u64p), cap,
            )
            if count < 0:
                reason = {
                    -1: "corrupt framing",
                    -2: "header CRC mismatch",
                    -3: "payload CRC mismatch",
                    -4: "index capacity exhausted",
                }.get(count, f"indexer error {count}")
                raise IOError(f"{path}: {reason}")
            self._offsets = offsets[:count]
            self._lengths = lengths[:count]
        else:
            offs, lens = [], []
            data, pos, n = self._mm, 0, total
            while pos < n:
                if pos + 12 > n:
                    raise IOError(
                        f"truncated record header at byte {pos} of {path}"
                    )
                (length,) = struct.unpack_from("<Q", data, pos)
                end = pos + 12 + length
                if end + 4 > n:
                    raise IOError(
                        f"truncated record payload at byte {pos} of {path}"
                    )
                if verify:
                    (hdr_crc,) = struct.unpack_from("<I", data, pos + 8)
                    (pay_crc,) = struct.unpack_from("<I", data, end)
                    if masked_crc32c(data[pos : pos + 8]) != hdr_crc:
                        raise IOError(
                            f"header CRC mismatch at byte {pos} of {path}"
                        )
                    if masked_crc32c(data[pos + 12 : end]) != pay_crc:
                        raise IOError(
                            f"payload CRC mismatch at byte {pos} of {path}"
                        )
                offs.append(pos + 12)
                lens.append(length)
                pos = end + 4
            self._offsets = np.asarray(offs, np.uint64)
            self._lengths = np.asarray(lens, np.uint64)

    def __len__(self) -> int:
        return len(self._offsets)

    def payload(self, i: int) -> bytes:
        off, length = int(self._offsets[i]), int(self._lengths[i])
        return bytes(self._mm[off : off + length])

    def example(self, i: int) -> dict[str, Any]:
        """Decode record ``i`` into the read_examples dict structure."""
        off, length = int(self._offsets[i]), int(self._lengths[i])
        if self._lib is not None:
            return _decode_example_native(
                self._lib, self._mm, self._base, off, length, self._path
            )
        return parse_example(self.payload(i))

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            del self._buf
            self._mm.close()
            self._mm = None
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
