"""TensorBoard event-file writer (TF-free).

The port's copy of ``ecog2txt_tpu/utils/summaries.py``, over the port's
own ``records``.

The reference forwards the manifest key ``tf_summaries_dir``
(mocha-1_word_sequence.yaml:85) to its TF2 trainer through ``ST_kwargs``
(reference trainers.py:110-115), which emits TensorBoard scalar
summaries of the training curves.  This module reproduces that
observability surface without TensorFlow: an event file is just a
TFRecord-framed stream of ``tensorflow.Event`` protobufs, and the
package already owns both the framing (``records.TFRecordWriter``) and
the wire-format helpers, so the writer is ~60 lines and the files load
in stock TensorBoard (cross-checked against TF's ``summary_iterator``
in tests/test_torch_trainer_tools.py).

Wire schema (tensorflow/core/util/event.proto, summary.proto):

    Event   { double wall_time = 1; int64 step = 2;
              string file_version = 3; Summary summary = 5; }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, Mapping

from ..records import (
    TFRecordWriter,
    _length_delimited,
    _read_varint,
    _tag,
    _varint,
    tfrecord_iterator,
)

__all__ = ["SummaryWriter", "iter_events"]


def _encode_event(
    wall_time: float,
    step: int | None = None,
    file_version: str | None = None,
    scalars: Mapping[str, float] | None = None,
) -> bytes:
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _tag(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _length_delimited(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _length_delimited(
                1,
                _length_delimited(1, tag.encode())
                + _tag(2, 5)
                + struct.pack("<f", float(value)),
            )
            for tag, value in scalars.items()
        )
        out += _length_delimited(5, summary)
    return out


class SummaryWriter:
    """Append scalar summaries to a TensorBoard event file.

    Creates ``logdir`` (recursively) and one
    ``events.out.tfevents.<time>.<host>`` file inside it; TensorBoard
    pointed at ``logdir`` (or any ancestor) picks the run up live.
    The first record is the standard ``brain.Event:2`` version stamp.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        # pid suffix keeps multi-controller runs from colliding on one
        # filename (TensorBoard accepts anything after the hostname)
        name = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()),
            socket.gethostname(),
            os.getpid(),
        )
        self.path = os.path.join(logdir, name)
        self._writer = TFRecordWriter(self.path)
        self._writer.write(
            _encode_event(time.time(), file_version="brain.Event:2")
        )

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.scalars({tag: value}, step)

    def scalars(self, mapping: Mapping[str, float], step: int) -> None:
        """One Event carrying every (tag, value) in ``mapping``."""
        self._writer.write(
            _encode_event(time.time(), step=step, scalars=mapping)
        )

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_events(path: str) -> Iterator[dict]:
    """Decode an event file back to dicts (``wall_time``, ``step``,
    and either ``file_version`` or ``scalars``).  TF-free readback for
    tests and quick inspection; TensorBoard remains the intended UI."""
    for payload in tfrecord_iterator(path, verify=True):
        event: dict = {"step": 0}
        pos = 0
        while pos < len(payload):
            key, pos = _read_varint(payload, pos)
            field, wire = key >> 3, key & 7
            if wire == 1:  # fixed64
                (val,) = struct.unpack_from("<d", payload, pos)
                pos += 8
                if field == 1:
                    event["wall_time"] = val
            elif wire == 0:  # varint
                val, pos = _read_varint(payload, pos)
                if field == 2:
                    event["step"] = val
            elif wire == 2:  # length-delimited
                size, pos = _read_varint(payload, pos)
                blob = payload[pos : pos + size]
                pos += size
                if field == 3:
                    event["file_version"] = blob.decode()
                elif field == 5:
                    event["scalars"] = _decode_summary(blob)
            elif wire == 5:  # fixed32
                pos += 4
            else:  # pragma: no cover - no other wire types emitted
                raise IOError(f"unexpected wire type {wire} in {path}")
        yield event


def _decode_summary(blob: bytes) -> dict[str, float]:
    scalars: dict[str, float] = {}
    pos = 0
    while pos < len(blob):
        key, pos = _read_varint(blob, pos)
        size, pos = _read_varint(blob, pos)
        value = blob[pos : pos + size]
        pos += size
        if key >> 3 != 1:
            continue
        tag, vpos, simple = "", 0, None
        while vpos < len(value):
            vkey, vpos = _read_varint(value, vpos)
            vfield, vwire = vkey >> 3, vkey & 7
            if vwire == 2:
                vsize, vpos = _read_varint(value, vpos)
                if vfield == 1:
                    tag = value[vpos : vpos + vsize].decode()
                vpos += vsize
            elif vwire == 5:
                if vfield == 2:
                    (simple,) = struct.unpack_from("<f", value, vpos)
                vpos += 4
            elif vwire == 0:
                _, vpos = _read_varint(value, vpos)
            elif vwire == 1:
                vpos += 8
        if simple is not None:
            scalars[tag] = simple
    return scalars
