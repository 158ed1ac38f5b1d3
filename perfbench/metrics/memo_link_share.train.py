"""memo_link_share.train: the π bytes the chunked memo store moved across
the host link over the traced updates (its own counters, ``link_stats()``,
both directions) over the device time of the traced window's host-to-device
and device-to-host copies at PCIe Gen5 x16's per-direction rate
(``perfbench/reference/link.py``), in %. None where the program keeps no
such counters or the window holds no such copy."""
from perfbench.harness.readout import traced
from perfbench.reference.link import PCIE_GEN5_X16_BYTES_PER_S


def is_link_copy(name: str) -> bool:
    return "HtoD" in name or "DtoH" in name


def read(rec):
    link = rec.get("link")
    if link is None or not traced(rec, "train"):
        return None
    seconds = rec["segment"].device_seconds(is_link_copy)
    if seconds <= 0:
        return None
    moved = link["bytes_in"] + link["bytes_out"]
    return 100.0 * moved / (seconds * PCIE_GEN5_X16_BYTES_PER_S)
