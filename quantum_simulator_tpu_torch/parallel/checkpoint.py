"""Per-shard checkpoints of mesh-sharded states, in the JAX package's files.

Counterpart of ``quantum_simulator_tpu/parallel/checkpoint.py``, writing
and reading the same layout, so a checkpoint one package writes resumes
in the other: each shard k (global shard index) saves its split planes
``shard_<k>_re.npy`` / ``shard_<k>_im.npy`` (``(2^(n-g),)`` in the
state's precision: float32, or float64 under ``config.enable_complex128``),
``manifest.json`` records ``num_shards``, ``global_shape`` ``[2^n]``,
``dtype`` (``"complex64"`` or ``"complex128"``, JAX's
``str(array.dtype)``) and the caller's ``meta``, and ``LATEST`` names the
newest complete ``seg_<k>/`` directory, replaced atomically
(``os.replace``) after the shards and the manifest are written; older
segment directories are then pruned. A crash mid-save leaves the previous
pointer and its files in place.

Every rank writes its own shards; with several ranks, rank 0 writes the
manifest and the pointer after a barrier, so the manifest appears only
once every shard is on disk. The state never exists whole anywhere: a
shard goes from the device to its two files and back. Besides JAX's run
identity the meta carries ``circuit_digest``, a hash of the circuit that
is the same in every process (``resume_segment``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .distributed import ShardMesh

__all__ = ["save_sharded_state", "load_sharded_state", "load_manifest",
           "write_latest", "read_latest", "circuit_digest",
           "resume_segment", "complex_name"]

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


def _barrier(mesh: ShardMesh | None) -> None:
    if mesh is not None and mesh.world > 1:
        dist.barrier(group=mesh.group)


def complex_name(real_dtype: torch.dtype) -> str:
    """The manifest's ``dtype`` of planes of ``real_dtype``:
    ``"complex64"`` for float32, ``"complex128"`` for float64."""
    return "complex128" if real_dtype == torch.float64 else "complex64"


def save_sharded_state(planar: torch.Tensor, directory: str,
                       mesh: ShardMesh, meta: dict | None = None) -> None:
    """Save this rank's planar ``(L, 2, 2^(n-g))`` stack, one file pair
    per shard; ``meta`` goes into the manifest verbatim."""
    os.makedirs(directory, exist_ok=True)
    for l, k in enumerate(mesh.shard_ids()):
        blk = planar[l].reshape(2, -1).cpu().numpy()
        np.save(os.path.join(directory, f"shard_{k}_re.npy"), blk[0])
        np.save(os.path.join(directory, f"shard_{k}_im.npy"), blk[1])
    _barrier(mesh)
    if mesh.rank == 0:
        manifest = {
            "num_shards": mesh.n_devices,
            "global_shape": [mesh.n_devices * planar[0, 0].numel()],
            "dtype": complex_name(planar.dtype),
            "meta": meta or {},
        }
        tmp = os.path.join(directory, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, os.path.join(directory, _MANIFEST))
    _barrier(mesh)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)


def load_sharded_state(directory: str, mesh: ShardMesh) -> torch.Tensor:
    """This rank's planar ``(L, 2, 2^(n-g))`` stack from a checkpoint (its
    own shards' files only, each moved to the device as it is read), in
    the manifest's precision: float64 planes for ``"complex128"``, float32
    ones for ``"complex64"``."""
    manifest = load_manifest(directory)
    if mesh.n_devices != manifest["num_shards"]:
        raise ValueError(
            f"checkpoint has {manifest['num_shards']} shards but the mesh "
            f"has {mesh.n_devices} devices — reshard is not supported")
    n_local = int(manifest["global_shape"][0]) // mesh.n_devices
    wide = manifest.get("dtype", "complex64") == "complex128"
    out = torch.empty((mesh.local, 2, n_local),
                      dtype=torch.float64 if wide else torch.float32,
                      device=mesh.device)
    for l, k in enumerate(mesh.shard_ids()):
        for plane, part in enumerate(("re", "im")):
            arr = np.load(os.path.join(directory, f"shard_{k}_{part}.npy"))
            out[l, plane].copy_(torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float64 if wide
                                     else np.float32)))
    return out


def write_latest(root: str, seg_dir: str, mesh: ShardMesh | None = None,
                 prune: bool = True) -> None:
    """Atomically point ``root/LATEST`` at ``seg_dir`` (a subdirectory
    name), then prune every other ``seg_*`` checkpoint under ``root``
    (rank 0 of ``mesh``; the ranks wait for it)."""
    if mesh is None or mesh.rank == 0:
        tmp = os.path.join(root, _LATEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(seg_dir)
        os.replace(tmp, os.path.join(root, _LATEST))
        if prune:
            for name in os.listdir(root):
                if name.startswith("seg_") and name != seg_dir and \
                        os.path.isdir(os.path.join(root, name)):
                    shutil.rmtree(os.path.join(root, name),
                                  ignore_errors=True)
    _barrier(mesh)


def read_latest(root: str) -> str | None:
    """Directory of the newest complete checkpoint under ``root``
    (absolute path), or None if there is none or it is incomplete."""
    path = os.path.join(root, _LATEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        seg_dir = f.read().strip()
    full = os.path.join(root, seg_dir)
    return full if os.path.exists(os.path.join(full, _MANIFEST)) else None


def circuit_digest(circuit) -> str:
    """SHA-256 of the circuit's JSON form (qubits, initial states, every
    gate with its parameters): the same in every process."""
    text = json.dumps(circuit.to_dict(), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


def resume_segment(directory: str | None, run: dict, digest: str) -> int:
    """The segment a rerun continues from: the checkpoint's
    ``next_segment`` when its identity matches, else 0. ``run`` is the
    JAX package's identity (``meta["run"]``), whose ``circuit_hash`` is
    Python's ``hash`` of the gate names and so equal only inside one
    process (a JAX-written checkpoint resumes in the process that wrote
    it, as in the JAX package); a checkpoint this package wrote also
    carries ``circuit_digest``, which with the rest of ``run`` matches in
    any process."""
    if directory is None:
        return 0
    meta = load_manifest(directory)["meta"]
    theirs = meta.get("run") or {}

    def rest(r: dict) -> dict:
        return {k: v for k, v in r.items() if k != "circuit_hash"}

    same = theirs == run or (meta.get("circuit_digest") == digest
                             and rest(theirs) == rest(run))
    return int(meta["next_segment"]) if same else 0
