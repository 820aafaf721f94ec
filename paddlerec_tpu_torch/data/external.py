"""External data sources: Kafka, ODPS (MaxCompute), TFRecord, plain files.

A copy of ``paddlerec_tpu/data/external.py`` (the reference's
tools/dataset/{kafka_reader.py, odps_reader.py, tfrecord_reader.py,
file_reader.py}): streaming line/record sources that feed the slot
parsers.  Heavy client libraries are optional (gated imports with
actionable errors); every source yields text lines or parsed records that
plug into the same SlotDataset batch assembly.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional


class KafkaLineSource:
    """Consume UTF-8 lines from Kafka topics (kafka_reader.py:22-48)."""

    def __init__(self, hosts: str, group_id: str, topics: List[str],
                 timeout: float = 5.0):
        try:
            from confluent_kafka import Consumer
        except ImportError as e:  # pragma: no cover - optional dep
            raise RuntimeError(
                "confluent_kafka is not installed; KafkaLineSource needs it"
            ) from e
        self._consumer = Consumer({
            "bootstrap.servers": hosts,
            "group.id": group_id,
            "message.max.bytes": 30000000,
            "default.topic.config": {"auto.offset.reset": "earliest"},
        })
        self._consumer.subscribe(topics)
        self.timeout = timeout

    def __iter__(self) -> Iterator[str]:
        while True:
            msg = self._consumer.poll(self.timeout)
            if msg is None:
                return
            if msg.error():
                continue
            yield msg.value().decode("utf-8")


class OdpsTableSource:
    """Stream rows from a MaxCompute table (odps_reader.py)."""

    def __init__(self, access_id: str, access_key: str, project: str,
                 endpoint: str, table: str, partition: Optional[str] = None):
        try:
            from odps import ODPS
        except ImportError as e:  # pragma: no cover - optional dep
            raise RuntimeError(
                "pyodps is not installed; OdpsTableSource needs it"
            ) from e
        self._odps = ODPS(access_id, access_key, project, endpoint)
        self.table = table
        self.partition = partition

    def __iter__(self):
        t = self._odps.get_table(self.table)
        with t.open_reader(partition=self.partition) as reader:
            for record in reader:
                yield list(record.values)


class TFRecordSource:
    """Raw TFRecord framing reader (tfrecord_reader.py) — dependency-free:
    each record is [length u64][crc u32][payload][crc u32]."""

    def __init__(self, paths: Iterable[str], verify_crc: bool = False):
        self.paths = list(paths)
        self.verify_crc = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        for path in self.paths:
            with open(path, "rb") as f:
                while True:
                    header = f.read(8)
                    if len(header) < 8:
                        break
                    (length,) = struct.unpack("<Q", header)
                    f.read(4)  # length crc
                    payload = f.read(length)
                    if len(payload) < length:
                        break
                    f.read(4)  # payload crc
                    yield payload


def write_tfrecord(path: str, records: Iterable[bytes]) -> None:
    """Writer with zeroed CRCs (enough for TFRecordSource round trips)."""
    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)))
            f.write(b"\x00" * 4)
            f.write(rec)
            f.write(b"\x00" * 4)


class FileLineSource:
    """Plain text files (file_reader.py)."""

    def __init__(self, paths: Iterable[str]):
        self.paths = list(paths)

    def __iter__(self) -> Iterator[str]:
        for path in self.paths:
            with open(path) as f:
                for line in f:
                    yield line.rstrip("\n")
