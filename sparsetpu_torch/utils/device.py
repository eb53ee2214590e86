"""Device selection and the card facts the benchmark needs (the counterpart
of ``sparsetpu/bench/harness.py``'s ``HBM_GBPS``/``detect_hbm_gbps``).

Every entry point that takes the JAX package's ``interpret=`` resolves its
device here, by one rule (``pick_device``): ``interpret=True`` is the
port's counterpart of Pallas interpret mode, the plain PyTorch versions on
the CPU; ``interpret=False`` (or None) changes nothing.  ``device`` keeps
its default ``"cuda"``, and nothing falls back to the CPU when no card is
found."""

from __future__ import annotations

import subprocess

import torch

# Device-memory bandwidth in GB/s from NVIDIA's data sheets, matched against
# torch.cuda.get_device_name() in this order (the SXM H100 reports itself as
# "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts carry their form factor).
HBM_GBPS = {
    "H100 NVL": 3900.0,
    "H100 PCIe": 2000.0,
    "H100 SXM": 3350.0,
    "H100 80GB HBM3": 3350.0,
    "H200": 4800.0,
}
# NVLink rate of the H100 SXM in one direction, GB/s (NVIDIA's data sheet:
# 900 GB/s of NVLink a card, both directions together).
NVLINK_GBPS = 450.0


class _DefaultDevice(str):
    """The default ``device``: ``"cuda"``, told apart (by identity) from a
    caller who names ``"cuda"``, so that ``interpret=True`` may take the
    CPU only when no device was named."""


CUDA = _DefaultDevice("cuda")


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no card
    is present (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pick_device(device=CUDA, interpret=None) -> torch.device:
    """The device of an entry point that takes ``interpret=``.

    ``interpret=True`` runs the plain PyTorch versions on the CPU: with the
    default device, or ``device="cpu"``; with a CUDA device named it
    raises ``ValueError`` rather than quietly pick one of the two.
    ``interpret`` False or None is ``require_device(device)``.  Anything
    but a bool or None raises ``TypeError`` (a device passed where the
    JAX package's signature has ``interpret``)."""
    if interpret is None or interpret is False:
        return require_device(device)
    if interpret is not True:
        raise TypeError(f"interpret must be a bool, got {interpret!r}")
    if device is CUDA:
        return torch.device("cpu")
    if torch.device(device).type == "cuda":
        raise ValueError(f"interpret=True runs the plain versions on the "
                         f"CPU; it cannot run on device={device!r}")
    return require_device(device)


def hbm_gbps(device) -> float:
    """Data-sheet device-memory bandwidth of the card behind ``device``;
    raises for a card not in ``HBM_GBPS`` rather than guessing."""
    dev = require_device(device)
    if dev.type != "cuda":
        raise ValueError("HBM bandwidth is defined for a CUDA device only")
    name = torch.cuda.get_device_name(dev)
    for key, gbps in HBM_GBPS.items():
        if key in name:
            return gbps
    raise KeyError(f"no HBM bandwidth on record for {name!r}")


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (name and power limit of each card, one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
