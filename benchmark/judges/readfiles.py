"""The numbers a READFILES cell compares: each phase reads every whole
block of every file once, so its device copies, the bytes the lanes landed
and (with --verify) the verify kernel's launches are the reference's
counts; with the corruption probe, the offset the port names is the byte
the harness flipped. The bytes in device memory are judged only by the
port's own verify kernel: the port exposes no read-back (PERF.md)."""

from benchmark import reference


def _max_gap(values) -> int:
    return max((abs(int(v)) for v in values), default=0)


def checks(port: dict, traffic: dict, phases: list, probe: dict | None
           ) -> tuple[dict, int]:
    """The numbers compared, and the device copies due in one phase."""
    ref = reference.read_pass(port["files"], port["file_bytes"],
                              port["block_bytes"])
    out = {
        "phase_errors": sum(1 for p in phases if p.error),
        "landed_bytes_gap": _max_gap(p.landed - ref["bytes"] for p in phases),
        "copies_gap": _max_gap(p.submits - ref["blocks"] for p in phases),
    }
    if traffic.get("verify"):
        out["verify_launch_gap"] = _max_gap(
            p.verify_launches - ref["blocks"] for p in phases)
    if probe is not None:
        # a miss counts as the widest gap the file allows
        got = probe["reported"]
        out["corrupt_offset_gap"] = (abs(got - probe["offset"])
                                     if got is not None
                                     else port["file_bytes"])
    return out, ref["blocks"]
