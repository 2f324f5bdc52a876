"""Periodic atomic training checkpoints (the JAX package's
robust/checkpoint.py; the same file format, so each package reads the
other's files).

One checkpoint is one self-validating file ``ckpt_<iteration>.lgbckpt``:

    <JSON header line: magic, format, iteration, nbytes, sha256>\\n
    <npz payload: arrays + ``__meta__`` JSON blob + model text bytes>

The header hash covers the whole payload, so a torn write (partial
rename, disk full mid-flush) is detected on load and the loader falls
back to the previous surviving checkpoint instead of resuming from
garbage. Writes are tmp-file + fsync + rename + directory fsync; the
last ``keep`` checkpoints are retained. In a ``torch.distributed``
group only rank 0 writes, between two barriers, so no rank races ahead
into state the checkpoint does not cover; every rank reads the same
file on resume.

The state dict handed to :meth:`CheckpointManager.save` may nest
plain-JSON values and numpy arrays (or tensors, stored through numpy)
arbitrarily; arrays are stored bit-exactly in the npz half (float32
round-trips exactly, which is what makes a resumed training equal to
the uninterrupted one byte for byte), everything else goes through
JSON.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..utils import log
from .faultinject import check_fault

MAGIC = "LGBMTPU_CKPT"
FORMAT_VERSION = 1
_FILE_RE = re.compile(r"^ckpt_(\d+)\.lgbckpt$")


class CheckpointError(Exception):
    """A checkpoint could not be written or no valid one could be read."""


# -- state <-> bytes ----------------------------------------------------

def _flatten(obj: Any, path: str, arrays: Dict[str, np.ndarray]) -> Any:
    """Split a nested state value into a JSON-able skeleton plus a flat
    dict of numpy arrays (keyed by their path in the skeleton)."""
    if isinstance(obj, np.ndarray):
        arrays[path] = obj
        return {"__ndarray__": path}
    if hasattr(obj, "__array__") and hasattr(obj, "dtype"):  # a tensor
        arrays[path] = np.asarray(obj.cpu() if hasattr(obj, "cpu") else obj)
        return {"__ndarray__": path}
    if isinstance(obj, dict):
        return {str(k): _flatten(v, f"{path}.{k}", arrays)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_flatten(v, f"{path}.{i}", arrays)
                for i, v in enumerate(obj)]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def _unflatten(skel: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(skel, dict):
        if set(skel.keys()) == {"__ndarray__"}:
            return arrays[skel["__ndarray__"]]
        return {k: _unflatten(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, arrays) for v in skel]
    return skel


def _pack_payload(state: Dict[str, Any], model_text: str) -> bytes:
    arrays: Dict[str, np.ndarray] = {}
    skel = _flatten(state, "s", arrays)
    npz: Dict[str, np.ndarray] = {
        f"arr{i}": a for i, a in enumerate(arrays.values())}
    keymap = {path: f"arr{i}" for i, path in enumerate(arrays.keys())}
    meta = {"state": skel, "keys": keymap}
    npz["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    npz["__model__"] = np.frombuffer(
        model_text.encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **npz)
    return buf.getvalue()


def _unpack_payload(payload: bytes) -> Tuple[Dict[str, Any], str]:
    npz = np.load(io.BytesIO(payload), allow_pickle=False)
    meta = json.loads(bytes(npz["__meta__"]).decode("utf-8"))
    arrays = {path: npz[slot] for path, slot in meta["keys"].items()}
    state = _unflatten(meta["state"], arrays)
    model_text = bytes(npz["__model__"]).decode("utf-8")
    return state, model_text


# -- manager ------------------------------------------------------------

def _group_ranks() -> Tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` group,
    (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_barrier() -> None:
    """A barrier over the default group when it has more than one rank."""
    if _group_ranks()[1] > 1:
        import torch.distributed as dist
        # tpulint: mesh-ok(checkpoint commit barrier: every rank saves at the same step)
        dist.barrier()


class CheckpointManager:
    """Owns one checkpoint directory: periodic save, prune, resume.

    ``params_digest`` fingerprints the training configuration
    (compile/signature.py); a checkpoint written under a different
    digest is refused on resume rather than silently mixed in.
    """

    def __init__(self, directory: str, interval: int = 50, keep: int = 2,
                 params_digest: str = "", barrier=None,
                 process_index: Optional[int] = None) -> None:
        if not directory:
            raise CheckpointError("checkpoint directory must be non-empty")
        self.directory = directory
        self.interval = max(int(interval), 0)
        self.keep = max(int(keep), 1)
        self.params_digest = params_digest
        self._barrier = barrier if barrier is not None else _default_barrier
        self._process_index = process_index

    # -- schedule -------------------------------------------------------
    def due(self, iteration: int) -> bool:
        """True when a checkpoint should be written after ``iteration``
        (0-based) completes."""
        return self.interval > 0 and (iteration + 1) % self.interval == 0

    # -- write ----------------------------------------------------------
    def _is_writer(self) -> bool:
        if self._process_index is not None:
            return self._process_index == 0
        return _group_ranks()[0] == 0

    def path_for(self, iteration: int) -> str:
        return os.path.join(self.directory, f"ckpt_{iteration:07d}.lgbckpt")

    def save(self, iteration: int, state: Dict[str, Any],
             model_text: str) -> Optional[str]:
        """Atomically write a checkpoint covering ``iteration`` completed
        iterations. Returns the final path, or None on a non-fatal write
        failure (training continues; the previous checkpoint survives)."""
        self._barrier()
        path = None
        if self._is_writer():
            try:
                path = self._write(iteration, state, model_text)
            except OSError as e:
                # disk trouble costs the checkpoint, never the run
                obs.inc("ckpt.write_errors")
                log.warning(
                    "checkpoint write failed at iteration %d (%s); training "
                    "continues, last valid checkpoint is retained", iteration, e)
        self._barrier()
        return path

    def _write(self, iteration: int, state: Dict[str, Any],
               model_text: str) -> Optional[str]:
        os.makedirs(self.directory, exist_ok=True)
        payload = _pack_payload(
            dict(state, params_digest=self.params_digest), model_text)
        header = json.dumps({
            "magic": MAGIC, "format": FORMAT_VERSION,
            "iteration": int(iteration), "nbytes": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest(),
        }).encode("utf-8") + b"\n"

        spec = check_fault("checkpoint.write")  # enospc/ioerror raise here
        torn = spec is not None and spec.mode == "torn"
        partial = spec is not None and spec.mode == "partial"
        if torn or partial:
            payload = payload[:len(payload) // 2]

        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(header)
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            if partial:
                # simulated crash mid-write: tmp file left behind, no
                # rename — the run "died" before the checkpoint landed
                log.warning("checkpoint write at iteration %d aborted by "
                            "injected partial-write fault", iteration)
                obs.inc("ckpt.write_errors")
                return None
            path = self.path_for(iteration)
            os.replace(tmp, path)
            tmp = None
            self._fsync_dir()
        finally:
            if tmp is not None and os.path.exists(tmp) and not partial:
                os.unlink(tmp)
        obs.inc("ckpt.saves")
        obs.inc("ckpt.bytes", len(header) + len(payload))
        log.info("Saved checkpoint %s (%d iterations, %d bytes)",
                 path, iteration, len(header) + len(payload))
        self._prune()
        return path

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    def _prune(self) -> None:
        """Drop everything strictly older than the newest ``keep``
        checkpoints. Only entries BELOW the kept window are unlinked, so
        a concurrent ``load_latest`` that picked a kept file never has
        it deleted under it; a reader racing on an already-pruned older
        file sees ``FileNotFoundError`` and walks on."""
        entries = self._list()
        if len(entries) <= self.keep:
            return
        keep_floor = entries[-self.keep][0]   # oldest kept iteration
        for it, name in entries:
            if it >= keep_floor:
                break
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass

    # -- read -----------------------------------------------------------
    def _list(self) -> List[Tuple[int, str]]:
        """(iteration, filename) pairs sorted ascending by iteration."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in names:
            m = _FILE_RE.match(name)
            if m:
                out.append((int(m.group(1)), name))
        out.sort()
        return out

    def load_latest(self) -> Optional[Tuple[int, Dict[str, Any], str]]:
        """Newest valid checkpoint as (iteration, state, model_text), or
        None when the directory holds no usable checkpoint. Invalid files
        (bad magic, size or hash mismatch, foreign params digest) are
        skipped with a warning — a torn final write falls back to the
        previous checkpoint instead of poisoning the resume."""
        for it, name in reversed(self._list()):
            path = os.path.join(self.directory, name)
            try:
                state, model_text = self._read(path)
            except FileNotFoundError:
                # a concurrent writer's prune removed an older entry
                # between our listing and the read: walk on
                continue
            except (CheckpointError, OSError, ValueError, KeyError) as e:
                obs.inc("ckpt.invalid")
                log.warning("Skipping invalid checkpoint %s: %s", path, e)
                continue
            digest = state.pop("params_digest", "")
            if self.params_digest and digest and digest != self.params_digest:
                obs.inc("ckpt.invalid")
                log.warning(
                    "Skipping checkpoint %s: written under different training "
                    "parameters (digest %s != %s)", path, digest,
                    self.params_digest)
                continue
            obs.inc("ckpt.resume")
            return it, state, model_text
        return None

    def _read(self, path: str) -> Tuple[Dict[str, Any], str]:
        with open(path, "rb") as fh:
            header_line = fh.readline()
            payload = fh.read()
        try:
            header = json.loads(header_line.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CheckpointError(f"unreadable header: {e}")
        if header.get("magic") != MAGIC:
            raise CheckpointError(f"bad magic {header.get('magic')!r}")
        if header.get("format") != FORMAT_VERSION:
            raise CheckpointError(
                f"unsupported format {header.get('format')!r}")
        if len(payload) != header.get("nbytes"):
            raise CheckpointError(
                f"payload is {len(payload)} bytes, header says "
                f"{header.get('nbytes')} (torn write?)")
        digest = hashlib.sha256(payload).hexdigest()
        if digest != header.get("sha256"):
            raise CheckpointError("payload hash mismatch (corrupt write?)")
        state, model_text = _unpack_payload(payload)
        return state, model_text
