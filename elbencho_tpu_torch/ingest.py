"""DL-ingestion dataset manifest: parsing, validation and generation.

A copy of the original package's ingest.py (host code only, no device
access), so the port's --ingest refusals and generated datasets match the
original's byte for byte.

The `--ingest` scenario models training-input ingestion (PAPERS.md arxiv
1810.03035 characterizes the TF pattern: shuffled small-record reads over
sharded dataset files; 2604.21275 bounds the shuffle window): a set of
equally-sized dataset shard files read as RECORDS (--recordsize much
smaller than --block), shuffled per epoch with a seeded bounded window and
batched into blocks for the device hot path by the engine's kPhaseIngest,
sealed by the direction-12 all-resident barrier.

Record-index manifest format (docs/INGEST.md):

    {"version": 1,
     "record_size": 4096,
     "shards": [
       {"path": "data/shard-00000.bin"},
       {"path": "data/shard-00001.bin", "bytes": 67108864}
     ]}

  - `path` is absolute or relative to the manifest file's directory.
  - every shard must exist, be non-empty, and all shards must share ONE
    size (the engine's record-index space is shards x records_per_shard).
  - `record_size` is optional; when present it must agree with
    --recordsize (or stands in for it), and must divide the shard size.
  - `bytes` is optional; when present it must match the file's real size.

Every malformed input is refused with a cause string (ProgException),
never silently skipped — an ingest run that silently dropped a shard would
still report a (meaningless) records/s figure.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from .exceptions import ProgException


@dataclass
class IngestShard:
    """One dataset shard file (all shards share one size; records are
    addressed by a global index over shards x records_per_shard)."""

    path: str
    bytes: int = 0


def _refuse(manifest_path: str, cause: str) -> ProgException:
    return ProgException(f"--ingest manifest {manifest_path}: {cause}")


def load_record_manifest(manifest_path: str) -> tuple[list[IngestShard], int]:
    """Parse + validate a record-index manifest. Returns (shards,
    record_size) with record_size 0 when the manifest does not carry one
    (--recordsize must then supply it). Shard existence, sizes and the
    equal-size rule are checked here — fail fast at config time, never
    mid-epoch."""
    try:
        with open(manifest_path) as f:
            doc = json.load(f)
    except OSError as e:
        raise _refuse(manifest_path, f"unreadable ({e.strerror or e})")
    except ValueError as e:
        raise _refuse(manifest_path, f"not valid JSON ({e})")
    if not isinstance(doc, dict) or not isinstance(doc.get("shards"), list):
        raise _refuse(manifest_path,
                      'missing the "shards" list (expected {"shards": '
                      '[{"path": ...}, ...]})')
    if not doc["shards"]:
        raise _refuse(manifest_path, '"shards" is empty - nothing to ingest')

    record_size = doc.get("record_size", 0)
    if not isinstance(record_size, int) or isinstance(record_size, bool) \
            or record_size < 0:
        raise _refuse(manifest_path,
                      '"record_size" must be a non-negative integer')

    base_dir = os.path.dirname(os.path.abspath(manifest_path))
    shards: list[IngestShard] = []
    seen_paths: dict[str, int] = {}
    for i, entry in enumerate(doc["shards"]):
        if not isinstance(entry, dict) or not entry.get("path"):
            raise _refuse(manifest_path, f'shard {i}: missing "path"')
        raw_path = str(entry["path"])
        path = raw_path if os.path.isabs(raw_path) \
            else os.path.join(base_dir, raw_path)

        norm = os.path.realpath(path)
        if norm in seen_paths:
            raise _refuse(manifest_path,
                          f"shard {i} ({raw_path}): duplicate shard path "
                          f"(already listed as shard {seen_paths[norm]})")
        seen_paths[norm] = i

        try:
            size = os.stat(path).st_size
        except OSError:
            raise _refuse(manifest_path,
                          f"shard {i} ({raw_path}): shard file not found")
        if size == 0:
            raise _refuse(manifest_path,
                          f"shard {i} ({raw_path}): zero-byte shard")
        declared = entry.get("bytes")
        if declared is not None:
            if not isinstance(declared, int) or declared <= 0:
                raise _refuse(manifest_path,
                              f'shard {i} ({raw_path}): "bytes" must be a '
                              "positive integer")
            if declared != size:
                raise _refuse(manifest_path,
                              f'shard {i} ({raw_path}): declared bytes '
                              f"({declared}) differ from the file size "
                              f"({size})")
        if shards and size != shards[0].bytes:
            raise _refuse(manifest_path,
                          f"shard {i} ({raw_path}) is {size} bytes, shard "
                          f"0 is {shards[0].bytes} - all dataset shards "
                          "must share one size (the record-index space is "
                          "shards x records_per_shard)")
        shards.append(IngestShard(path=path, bytes=size))
    if record_size and shards[0].bytes % record_size:
        raise _refuse(manifest_path,
                      f'"record_size" ({record_size}) must divide the '
                      f"shard size ({shards[0].bytes})")
    return shards, record_size


def generated_dataset_shards(dir_path: str, nshards: int, shard_bytes: int,
                             must_exist: bool) -> list[IngestShard]:
    """The --ingestshards N dataset: N shard files named data.shard.<i>
    under the bench directory, -s/--size bytes each. must_exist: without
    -w the files must already be present (and exactly sized) — with -w the
    prepare step creates them."""
    if nshards < 1:
        raise ProgException("--ingestshards must be >= 1")
    if shard_bytes <= 0:
        raise ProgException(
            "--ingestshards needs -s/--size for the per-shard bytes")
    shards = []
    for i in range(nshards):
        path = os.path.join(dir_path, f"data.shard.{i}")
        if must_exist:
            try:
                size = os.stat(path).st_size
            except OSError:
                raise ProgException(
                    f"--ingestshards: shard file not found: {path} "
                    "(add -w to create the generated dataset)")
            if size == 0:
                raise ProgException(
                    f"--ingestshards: zero-byte shard: {path}")
            if size != shard_bytes:
                raise ProgException(
                    f"--ingestshards: {path} is {size} bytes, -s/--size "
                    f"says {shard_bytes}")
        shards.append(IngestShard(path=path, bytes=shard_bytes))
    return shards


def write_generated_dataset(shards: list[IngestShard]) -> None:
    """Create/size the generated dataset shard files (the -w prepare step;
    setup, never measured). Content is random so device transfers move
    real data."""
    for shard in shards:
        blk = os.urandom(min(1 << 20, shard.bytes))
        with open(shard.path, "wb") as f:
            written = 0
            while written < shard.bytes:
                n = min(len(blk), shard.bytes - written)
                f.write(blk[:n])
                written += n
