"""What the port's command-line entry points share: the ``--device``
argument and the device check before any simulation.

The JAX scripts begin with a preflight that pins the CPU when the
accelerator cannot be reached. The port's entry points never fall back:
a CUDA device that is not there is an error, and the host runs only when
the caller names it (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import CONFIG


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the port's CONFIG.device, "
             "the card); 'cpu' runs the plain PyTorch twins on the host")


def open_device(name: str | None, prog: str) -> torch.device | None:
    """The device ``name`` (default ``CONFIG.device``), or None, with a
    message on stderr, where it is a CUDA device and none is present."""
    dev = torch.device(name or CONFIG.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (torch.cuda.is_available() is "
              "false); pass --device cpu to run on the host",
              file=sys.stderr)
        return None
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name for a CUDA device, else the device's type."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def release(dev) -> None:
    """Return the allocator's cached blocks to the card once the caller
    has dropped its references (the JAX scripts' ``.delete()``)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def emit(output: dict, path: str | None, note: str = "Results saved to",
         **dump) -> None:
    """Write ``output`` as JSON to ``path``, or print it to stdout."""
    if path:
        with open(path, "w") as f:
            json.dump(output, f, indent=2, **dump)
        print(f"{note} {path}")
    else:
        print(json.dumps(output, indent=2, **dump))
