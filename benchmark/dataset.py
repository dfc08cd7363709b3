"""The data set a cell reads: made from the reference pattern, kept inside
the checkout, flushed, and read once before the window.

Every run reads the same files; the seed picks their order and where the
corruption probe writes. So the files are written once per checkout, in a
directory named by their shape (build/portbench/<files>x<bytes>-<salt>/,
shared by the configurations of that shape), flushed with fsync, and later
runs only warm them. That keeps what a check writes to the host's disk to
one data set per shape and side, and keeps writeback out of every window.

The corruption probe flips one byte of one file and puts it back. A marker
written before the flip names the byte, so a run that dies in between
leaves the next run something to repair.
"""

from __future__ import annotations

import contextlib
import json
import os

from . import reference

CHUNK = 64 << 20


def data_dir(root: str, files: int, nbytes: int, salt: int) -> str:
    return os.path.join(root, "build", "portbench",
                        f"{files}x{nbytes}-{salt}")


def file_paths(directory: str, files: int) -> list[str]:
    # the port's --ingestshards names: data.shard.<i>
    return [os.path.join(directory, f"data.shard.{i}") for i in range(files)]


def _write_file(path: str, nbytes: int, salt: int) -> None:
    with open(path, "wb") as f:
        for off in range(0, nbytes, CHUNK):
            f.write(reference.pattern(off, min(CHUNK, nbytes - off),
                                      salt).tobytes())
        f.flush()
        os.fsync(f.fileno())


def _stamp(files: int, nbytes: int, salt: int) -> str:
    return json.dumps({"files": files, "bytes": nbytes, "salt": salt})


def ensure(directory: str, files: int, nbytes: int, salt: int) -> list[str]:
    """The data set's paths, written if it is missing or of another shape,
    with any byte a killed probe left flipped put back."""
    os.makedirs(directory, exist_ok=True)
    paths = file_paths(directory, files)
    repair_probe(directory)
    stamp_path = os.path.join(directory, "complete")
    try:
        with open(stamp_path) as f:
            whole = f.read() == _stamp(files, nbytes, salt)
    except OSError:
        whole = False
    whole = whole and all(os.path.isfile(p) and
                          os.path.getsize(p) == nbytes for p in paths)
    if not whole:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(stamp_path)
        for p in paths:
            _write_file(p, nbytes, salt)
        with open(stamp_path, "w") as f:
            f.write(_stamp(files, nbytes, salt))
            f.flush()
            os.fsync(f.fileno())
    return paths


def warm(paths: list[str]) -> int:
    """Read every file once, untimed, so the window reads a warm page
    cache. Returns the bytes read."""
    buf = bytearray(CHUNK)
    view = memoryview(buf)
    total = 0
    for p in paths:
        with open(p, "rb", buffering=0) as f:
            while n := f.readinto(view):
                total += n
    return total


def _probe_marker(directory: str) -> str:
    return os.path.join(directory, "probe")


def flip_byte(directory: str, path: str, offset: int) -> None:
    """Corrupt one byte on purpose (the probe), marker first."""
    with open(path, "r+b") as f:
        f.seek(offset)
        old = f.read(1)[0]
        with open(_probe_marker(directory), "w") as m:
            json.dump({"path": path, "offset": offset, "byte": old}, m)
            m.flush()
            os.fsync(m.fileno())
        f.seek(offset)
        f.write(bytes([old ^ 0xFF]))


def repair_probe(directory: str) -> None:
    """Put back the byte the probe flipped, if a marker names one."""
    marker = _probe_marker(directory)
    try:
        with open(marker) as m:
            probe = json.load(m)
    except OSError:
        return
    except ValueError:
        # cut while the marker was written: the flip comes after it
        os.unlink(marker)
        return
    with open(probe["path"], "r+b") as f:
        f.seek(probe["offset"])
        f.write(bytes([probe["byte"]]))
        f.flush()
        os.fsync(f.fileno())
    os.unlink(marker)
