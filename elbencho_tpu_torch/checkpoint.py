"""Checkpoint-restore manifest: parsing, validation and generation.

The port's copy of the parts of the original package's checkpoint.py that
the restore and reshard scenarios use (the manifest, placement checks,
generated shards, the N->M reshard planner and page-cache eviction).

The `--checkpoint` scenario models the serving cold-start pattern (PAPERS.md
arxiv 2605.25645 makes time-to-serve the headline metric; 2204.06514 fixes
the pjit shard-per-device layout): a manifest of shard files, each with an
explicit placement onto the selected device list, restored by the engine's
kPhaseCheckpointRestore as concurrent many-shard sequential reads sealed by
the direction-10 all-resident barrier.

Manifest format (docs/CHECKPOINT.md):

    {"version": 1,
     "shards": [
       {"path": "weights/shard-0.bin", "device": 0},
       {"path": "weights/shard-1.bin", "devices": [1, 2], "bytes": 1048576}
     ]}

  - `path` is absolute or relative to the manifest file's directory.
  - `device` (one index) or `devices` (a list — replicated placement)
    indexes the --gpuids SELECTION ORDER (position, not raw id).
  - `bytes` is optional; when present it must match the file's real size.

Every malformed input is refused with a cause string (ProgException), never
silently skipped: a missing shard file, a placement referencing a device
outside the selection, a duplicate device within one shard's placement, a
duplicate shard path, and a zero-byte shard are each configuration errors —
a restore that silently dropped a shard would still report a (meaningless)
time-to-resident.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .exceptions import ProgException


@dataclass
class CheckpointShard:
    """One manifest shard: a file restored to the listed device indices
    (positions in the --gpuids selection order; len > 1 = replicated)."""

    path: str
    devices: list[int] = field(default_factory=list)
    bytes: int = 0


def _refuse(manifest_path: str, cause: str) -> ProgException:
    return ProgException(f"--checkpoint manifest {manifest_path}: {cause}")


def write_manifest(manifest_path: str,
                   shards: list[CheckpointShard]) -> None:
    """Write a manifest file in the schema load_manifest parses — THE
    single writer authority (the campaign model-fixture kit and the
    bench serving leg both emit manifests; hand-rolling the schema in
    each would let the writers drift from this parser)."""
    doc = {"version": 1,
           "shards": [{"path": s.path, "bytes": s.bytes,
                       "devices": list(s.devices)} for s in shards]}
    with open(manifest_path, "w") as f:
        json.dump(doc, f)


def load_manifest(manifest_path: str) -> list[CheckpointShard]:
    """Parse + structurally validate a manifest file. Shard file existence
    and sizes are checked here too (the restore must fail fast at config
    time, not mid-phase); the device-RANGE check needs the resolved device
    count and lives in validate_placement()."""
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
                      '[{"path": ..., "device": N}, ...]})')
    if not doc["shards"]:
        raise _refuse(manifest_path, '"shards" is empty - nothing to restore')

    base_dir = os.path.dirname(os.path.abspath(manifest_path))
    shards: list[CheckpointShard] = []
    seen_paths: dict[str, int] = {}
    for i, entry in enumerate(doc["shards"]):
        if not isinstance(entry, dict) or not entry.get("path"):
            raise _refuse(manifest_path,
                          f'shard {i}: missing "path"')
        raw_path = str(entry["path"])
        path = raw_path if os.path.isabs(raw_path) \
            else os.path.join(base_dir, raw_path)

        if "devices" in entry:
            devs = entry["devices"]
        elif "device" in entry:
            devs = [entry["device"]]
        else:
            raise _refuse(manifest_path,
                          f'shard {i} ({raw_path}): missing "device" (or '
                          '"devices") placement')
        if not isinstance(devs, list) or not devs or \
                not all(isinstance(d, int) and not isinstance(d, bool)
                        and d >= 0 for d in devs):
            raise _refuse(manifest_path,
                          f"shard {i} ({raw_path}): placement must be a "
                          "non-empty list of device indices >= 0")
        dupes = {d for d in devs if devs.count(d) > 1}
        if dupes:
            raise _refuse(manifest_path,
                          f"shard {i} ({raw_path}): duplicate device "
                          f"assignment {sorted(dupes)} - each replica "
                          "device may be listed once")

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
        shards.append(CheckpointShard(path=path, devices=list(devs),
                                      bytes=size))
    return shards


def validate_placement(shards: list[CheckpointShard], num_devices: int,
                       origin: str) -> None:
    """Refuse any placement outside the selected device list. Runs at
    config time when --gpuids pins the count, and again at prepare against
    the device count the native path actually resolved."""
    for i, shard in enumerate(shards):
        bad = [d for d in shard.devices if d >= num_devices]
        if bad:
            raise ProgException(
                f"{origin}: shard {i} ({shard.path}) places onto device "
                f"index(es) {bad}, outside the selected device list "
                f"({num_devices} device(s); indices are positions in the "
                "--gpuids selection order)")


def generated_shards(dir_path: str, nshards: int, shard_bytes: int,
                     num_devices: int | None,
                     must_exist: bool) -> list[CheckpointShard]:
    """The --checkpoint-shards N manifest: N shard files named
    ckpt.shard.<i> under the bench directory, shard i placed on device
    i % num_devices (None = placement resolved at prepare, once the native
    path reports its device count). must_exist: without -w the files must
    already be present (and non-empty) — with -w the prepare step creates
    them at shard_bytes."""
    if nshards < 1:
        raise ProgException("--checkpoint-shards must be >= 1")
    if shard_bytes <= 0:
        raise ProgException(
            "--checkpoint-shards needs -s/--size for the per-shard bytes")
    shards = []
    for i in range(nshards):
        path = os.path.join(dir_path, f"ckpt.shard.{i}")
        if must_exist:
            try:
                size = os.stat(path).st_size
            except OSError:
                raise ProgException(
                    f"--checkpoint-shards: shard file not found: {path} "
                    "(add -w to create the generated shards)")
            if size == 0:
                raise ProgException(
                    f"--checkpoint-shards: zero-byte shard: {path}")
            if size != shard_bytes:
                raise ProgException(
                    f"--checkpoint-shards: {path} is {size} bytes, "
                    f"-s/--size says {shard_bytes}")
        devices = [i % num_devices] if num_devices else []
        shards.append(CheckpointShard(path=path, devices=devices,
                                      bytes=shard_bytes))
    return shards


def resolve_generated_placement(shards: list[CheckpointShard],
                                num_devices: int) -> None:
    """Fill the deferred i % num_devices placement of generated shards
    (empty device lists) once the native path's device count is known."""
    if num_devices < 1:
        raise ProgException("--checkpoint: no devices selected")
    for i, shard in enumerate(shards):
        if not shard.devices:
            shard.devices = [i % num_devices]


def write_generated_shards(shards: list[CheckpointShard],
                           fill_block: bytes = b"") -> None:
    """Create/size the generated shard files (the -w prepare step; setup,
    never measured). Content is incompressible-ish random so device
    transfers move real data."""
    for shard in shards:
        blk = fill_block or os.urandom(min(1 << 20, shard.bytes))
        with open(shard.path, "wb") as f:
            written = 0
            while written < shard.bytes:
                n = min(len(blk), shard.bytes - written)
                f.write(blk[:n])
                written += n


# ------------------------------------------------ N->M reshard planner
#
# Topology-shift restore (--reshard M, docs/RESHARD.md): the manifest
# describes where shards were resident on the slice shape the checkpoint
# was last restored onto (N devices); the target is the first M devices
# of the live selection. Resharding IS replanning with data motion (the
# stripe planner / survivor-map lineage): the planner diffs the two
# placements and emits one unit per (shard, target-device) pair —
#
#   "resident": the target already holds the shard; no motion.
#   "move":     a live device holds the shard; its bytes move
#               device->device through HBM (the D2D tier).
#   "read":     no live device holds it (the checkpoint's slice was
#               wider than this one, N > live devices) — restore from
#               storage.
#
# Target placement is shard i -> device i % M, the same deterministic
# round-robin rule generated manifests use — so an N==M reshard of a
# generated manifest is the identity plan (every unit "resident", zero
# moves, byte-identical to a plain restore by construction).


@dataclass
class ReshardUnit:
    """One reshard plan unit: how shard `shard` becomes resident on
    target device `dst_dev` (actions: "resident" / "move" / "read")."""

    shard: int
    action: str
    src_dev: int  # resident source lane (moves; -1 otherwise)
    dst_dev: int  # target lane
    bytes: int
    path: str  # shard file (reads + move fallbacks)


def plan_reshard(shards: list[CheckpointShard], num_devices: int,
                 target_devices: int) -> list[ReshardUnit]:
    """Diff the manifest's placement against the `target_devices`-wide
    target selection and emit the N->M reshard plan: one unit per
    (shard, target) pair, every shard's bytes placed exactly once.

    `num_devices` is the LIVE selected-device count — both the move
    sources and every target lane must be live, so target_devices must
    be <= num_devices (the session models the union of the old and new
    slice shapes; consolidation M < N drains the evicted lanes, growth
    M > N spreads onto lanes the manifest never placed onto)."""
    if target_devices < 1:
        raise ProgException("--reshard must target >= 1 device")
    if target_devices > num_devices:
        raise ProgException(
            f"--reshard {target_devices} targets more devices than the "
            f"live selection has ({num_devices}); the reshard session "
            "needs every target lane live (select more devices, or a "
            "smaller target)")
    units: list[ReshardUnit] = []
    for i, shard in enumerate(shards):
        dst = i % target_devices
        live_sources = [d for d in shard.devices if d < num_devices]
        if dst in live_sources:
            units.append(ReshardUnit(shard=i, action="resident", src_dev=dst,
                                     dst_dev=dst, bytes=shard.bytes,
                                     path=shard.path))
        elif live_sources:
            # nearest live replica: deterministic pick, lowest lane index
            src = min(live_sources)
            units.append(ReshardUnit(shard=i, action="move", src_dev=src,
                                     dst_dev=dst, bytes=shard.bytes,
                                     path=shard.path))
        else:
            units.append(ReshardUnit(shard=i, action="read", src_dev=-1,
                                     dst_dev=dst, bytes=shard.bytes,
                                     path=shard.path))
    return units


def reshard_plan_summary(units: list[ReshardUnit]) -> dict[str, int]:
    """Plan-shape counts (units by action + bytes in motion) for logs and
    the bench record."""
    out = {"units": len(units), "resident": 0, "move": 0, "read": 0,
           "move_bytes": 0, "read_bytes": 0}
    for u in units:
        out[u.action] += 1
        if u.action == "move":
            out["move_bytes"] += u.bytes
        elif u.action == "read":
            out["read_bytes"] += u.bytes
    return out


_DROPCACHES_WARNED = False


def drop_page_cache(shards: list[CheckpointShard],
                    mode: str = "fadvise") -> str:
    """Page-cache eviction before a cold restore session. Returns the mode
    ACTUALLY used (the bench records it as ckpt_cold_mode):

    - "fadvise" (default): per-file POSIX_FADV_DONTNEED — unprivileged
      best-effort, but dirty or shared pages can survive it, so the "cold"
      variant is a lower bound on true cold-start.
    - "dropcaches": sync + write 3 to /proc/sys/vm/drop_caches — the
      privileged TRUE-cold variant (drops every clean page + dentries/
      inodes machine-wide). Falls back to fadvise with one logged cause
      when the write is refused (unprivileged / read-only /proc)."""
    global _DROPCACHES_WARNED
    if mode == "dropcaches":
        try:
            os.sync()
            with open("/proc/sys/vm/drop_caches", "w") as f:
                f.write("3")
            return "dropcaches"
        except OSError as e:
            if not _DROPCACHES_WARNED:
                _DROPCACHES_WARNED = True
                from .logger import LOGGER

                LOGGER.warning(
                    f"--dropcaches unavailable ({e}); cold restore "
                    "sessions fall back to per-file fadvise "
                    "(ckpt_cold_mode: fadvise)")
    for shard in shards:
        try:
            fd = os.open(shard.path, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
        except OSError:
            pass
    return "fadvise"
