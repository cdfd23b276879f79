"""Checkpoint/resume with the reference's rank-0-writes convention.

Counterpart of ``horovod_tpu/training/checkpoint.py`` (its replicated
convention). Only rank 0 writes (``ModelCheckpointCallback``), everyone
restores by broadcast, and the resume epoch is agreed on with
:func:`agree_on_resume_epoch` — the newest epoch verified loadable on EVERY
rank, a set intersection over each rank's verified epochs.

Crash safety: every write is atomic (tmp + fsync + ``os.replace`` + a
directory fsync, so a crash mid-save never leaves a truncated file under the
final name) and every checkpoint carries a CRC32 manifest
(``checkpoint-NNNNN.manifest.json``, the reference's schema) written after
the payload. The scans and the loader verify size and CRC against the
manifest and fall back to the newest COMPLETE epoch, skipping torn or
corrupt files with a warning, so a resume after a crash never picks a torn
write. ``HOROVOD_FAULT_INJECT=torn_write@epoch=N`` leaves epoch N's payload
torn, for drills.

The payload is ``torch.save`` of ``{"model": state_dict, "optimizer":
state_dict, "epoch": N}`` (:meth:`Trainer.train_state`), serialized to bytes
first so that the CRC covers exactly the bytes written, in
``checkpoint-NNNNN.pt``, and it is read back with ``torch.load(...,
weights_only=True)``. (The reference writes flax msgpack,
``checkpoint-NNNNN.msgpack``: an intended divergence, ROADMAP §C.)

The sharded convention is for rank-divergent state (the ZeRO modes' shards:
``Trainer(sharded=True)``, ``sharding="zero2"|"zero3"``): EVERY rank calls
:func:`save_sharded` and writes its own ``checkpoint-NNNNN.shardRRR.pt``
(RRR its global rank: a process is a rank, where the reference writes one
file a process) with its own manifest, and :func:`load_sharded` reads the
rank's own file back, agreeing with the group on the epoch when asked for
the newest.
"""

from __future__ import annotations

import io
import json
import os
import re
import warnings
import zlib

import torch

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import resilience as _res
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll

_FILE_RE = re.compile(r"checkpoint-(\d+)\.pt$")
_SHARD_FILE_RE = re.compile(r"checkpoint-(\d+)\.shard\d+\.pt$")


def _path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"checkpoint-{epoch:05d}.pt")


def _manifest_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"checkpoint-{epoch:05d}.manifest.json")


def _shard_path(directory: str, epoch: int, pid: int) -> str:
    return os.path.join(directory, f"checkpoint-{epoch:05d}.shard{pid:03d}.pt")


def _shard_manifest_path(directory: str, epoch: int, pid: int) -> str:
    return os.path.join(
        directory, f"checkpoint-{epoch:05d}.shard{pid:03d}.manifest.json")


def _pid() -> int:
    """The shard index of this process: its global rank (0 before
    ``hvd.init``)."""
    return _state.global_rank() if _state.is_initialized() else 0


def _atomic_write(path: str, data: bytes, *, fault_epoch: int | None = None
                  ) -> None:
    """Write ``data`` so that ``path`` only ever holds the complete bytes:
    tmp file, fsync, ``os.replace``, fsync the directory. The tmp name is
    per-process: several ranks writing the SAME epoch to shared storage
    never clobber one inode mid-write, and their replaces race benignly
    (identical bytes, last one wins). With a matching ``torn_write`` fault
    injected, instead leave a truncated file at the final path — the
    artifact a writer killed mid-``f.write`` leaves — so the verify-and-
    fall-back recovery path is drillable."""
    if _res.injector().torn_write_due(fault_epoch):
        with open(path, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _write_manifest(manifest_path: str, epoch: int,
                    payloads: dict[str, bytes]) -> None:
    """Manifest of the INTENDED payload bytes (never re-read from disk: a
    torn payload must mismatch its manifest, that is the detection)."""
    manifest = {
        "epoch": epoch,
        "files": {
            name: {"crc32": zlib.crc32(data) & 0xFFFFFFFF,
                   "size": len(data)}
            for name, data in payloads.items()
        },
    }
    _atomic_write(manifest_path, json.dumps(manifest).encode())


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _verify_manifest(directory: str, data_path: str, manifest_path: str,
                     *, crc: bool = True) -> tuple[bool, str]:
    """(complete?, why). No manifest = a checkpoint written without one,
    accepted unverified. ``crc=False`` checks existence and sizes only — a
    stat, no payload read — which is what detects a torn write (a crashed
    writer leaves a short file); the full CRC additionally catches
    same-size bit corruption."""
    if not os.path.exists(data_path):
        return False, "data file missing"
    if not os.path.exists(manifest_path):
        return True, "no manifest (pre-manifest checkpoint, unverified)"
    try:
        with open(manifest_path) as f:
            entries = json.load(f)["files"]
    except (OSError, ValueError, KeyError) as e:
        return False, f"unreadable manifest ({e})"
    for fname, ent in entries.items():
        fp = os.path.join(directory, fname)
        if not os.path.exists(fp):
            return False, f"{fname} missing"
        size = os.path.getsize(fp)
        if size != ent["size"]:
            return False, (f"{fname} is {size} bytes, manifest says "
                           f"{ent['size']} (torn write)")
        if crc and _crc32_file(fp) != ent["crc32"]:
            return False, f"{fname} fails its manifest CRC32 (corrupt)"
    return True, "ok"


def verify_epoch(directory: str, epoch: int,
                 *, crc: bool = True) -> tuple[bool, str]:
    """Is the checkpoint at ``epoch`` complete? Returns ``(ok, why)``;
    ``why`` names the torn/corrupt/missing file. ``crc=False`` is the cheap
    size-only check (catches torn writes, not same-size corruption)."""
    return _verify_manifest(directory, _path(directory, epoch),
                            _manifest_path(directory, epoch), crc=crc)


def verify_sharded_epoch(directory: str, epoch: int,
                         pid: int | None = None,
                         *, crc: bool = True) -> tuple[bool, str]:
    """Is THIS rank's shard of ``epoch`` complete? (Each rank verifies only
    the shard it will load; ``pid`` names another.)"""
    if pid is None:
        pid = _pid()
    return _verify_manifest(directory, _shard_path(directory, epoch, pid),
                            _shard_manifest_path(directory, epoch, pid),
                            crc=crc)


def save(directory: str, state: dict, epoch: int) -> str:
    """Write a checkpoint (the caller applies the rank-0 gate; the
    ModelCheckpointCallback does). ``state`` is what
    :meth:`Trainer.train_state` returns; ``epoch`` is stored in it.

    The write is atomic (tmp + fsync + rename) and followed by a CRC32
    manifest; an epoch is only complete once its manifest verifies, so a
    crash at ANY point during save leaves the previous complete epoch as
    the resume point."""
    os.makedirs(directory, exist_ok=True)
    buf = io.BytesIO()
    torch.save(dict(state, epoch=epoch), buf)
    data = buf.getvalue()
    path = _path(directory, epoch)
    _atomic_write(path, data, fault_epoch=epoch)
    _write_manifest(_manifest_path(directory, epoch), epoch,
                    {os.path.basename(path): data})
    return path


def _scan_epochs(directory: str, pattern) -> list[int]:
    """All epochs with a matching file, newest first."""
    if not os.path.isdir(directory):
        return []
    found = set()
    for name in os.listdir(directory):
        m = pattern.search(name)
        if m:
            found.add(int(m.group(1)))
    return sorted(found, reverse=True)


# How many newest verified epochs each rank reports during resume
# agreement. The agreement scan is size-only (a stat per file, no payload
# reads — torn writes are short files), so this bounds the allgather
# payload, not I/O; epochs older than the K newest verified cannot be
# agreed on. The AGREED epoch alone gets one full CRC read per rank before
# it is returned.
_AGREE_K = 16


def _verified_epochs(directory: str, pattern, verifier, label: str,
                     limit: int | None = None) -> list[int]:
    """Epochs whose ``verifier(epoch)`` passes, newest first, at most
    ``limit`` of them; torn/corrupt epochs are skipped with a warning."""
    out: list[int] = []
    for epoch in _scan_epochs(directory, pattern):
        ok, why = verifier(epoch)
        if ok:
            out.append(epoch)
            if limit is not None and len(out) >= limit:
                break
            continue
        warnings.warn(
            f"Skipping incomplete {label} epoch {epoch} in {directory}: "
            f"{why}", RuntimeWarning, stacklevel=3)
    return out


def latest_epoch(directory: str, *, verify: bool = True) -> int:
    """Newest COMPLETE checkpoint epoch, or -1: epochs whose payload fails
    its CRC32 manifest (a torn write from a crashed writer, or on-disk
    corruption) are skipped with a warning, so resume lands on the newest
    checkpoint that is guaranteed loadable. ``verify=False`` is the raw
    highest-number scan."""
    if not verify:
        epochs = _scan_epochs(directory, _FILE_RE)
        return epochs[0] if epochs else -1
    epochs = _verified_epochs(
        directory, _FILE_RE, lambda e: verify_epoch(directory, e),
        "checkpoint", limit=1)
    return epochs[0] if epochs else -1


def save_sharded(directory: str, state: dict, epoch: int,
                 group: int = 0) -> str | None:
    """Write this rank's SHARDED state (what :meth:`Trainer.train_state`
    returns under a ZeRO mode): EVERY rank calls this and writes its own
    shard file — no rank-0 gate, nothing is dropped. A rank that is not a
    member of ``group`` has no shard and writes nothing (returns None).
    Restore with :func:`load_sharded` under the same ranks. Atomic, with a
    CRC32 manifest, as :func:`save`."""
    if _state.rank(group) < 0:
        return None
    os.makedirs(directory, exist_ok=True)
    buf = io.BytesIO()
    torch.save(dict(state, epoch=epoch), buf)
    data = buf.getvalue()
    pid = _pid()
    path = _shard_path(directory, epoch, pid)
    _atomic_write(path, data, fault_epoch=epoch)
    _write_manifest(_shard_manifest_path(directory, epoch, pid), epoch,
                    {os.path.basename(path): data})
    return path


def load_sharded(directory: str, template: dict, epoch: int | None = None,
                 group: int = 0, *, verify: bool = True) -> dict:
    """Restore this rank's sharded state saved by :func:`save_sharded`
    (its own shard file, on the CPU, through ``torch.load(weights_only=
    True)``); ``template`` must have the payload's keys. A rank that is
    not a member of ``group`` returns ``template`` unchanged (but still
    takes part in the ``epoch=None`` agreement).

    ``epoch=None`` is a COLLECTIVE: every rank size-verifies its own shards
    and the group agrees on the newest epoch verified on EVERY rank (the
    set intersection of :func:`agree_on_resume_epoch`), which each rank
    then CRC-verifies. Without the agreement a rank whose newest shard is
    torn would restore an older epoch than its peers. No rank has a
    loadable shard -> ``FileNotFoundError``; some do but no epoch is
    loadable everywhere -> ``HorovodError``. An explicit ``epoch`` that
    fails its integrity check raises (``verify=False`` skips that
    check)."""
    member = _state.rank(group) >= 0
    pid = _pid()
    if epoch is None:
        local_epochs = _verified_epochs(
            directory, _SHARD_FILE_RE,
            lambda e: verify_sharded_epoch(directory, e, pid, crc=False),
            "sharded checkpoint", limit=_AGREE_K) if member else []
        epoch, newest = _agree_newest_common(
            local_epochs, group, "hvd.agree_sharded_epoch")
        if not member:
            return template
        if epoch < 0:
            if newest >= 0:
                raise HorovodError(
                    f"No sharded checkpoint epoch in {directory} is "
                    f"loadable on EVERY process (the newest loadable epoch "
                    f"on some process is {newest}). A torn shard from a "
                    f"crashed writer, or a process topology change, leaves "
                    f"that process unable to match its peers; restore the "
                    f"missing shard or resume from a replicated-convention "
                    f"checkpoint.")
            raise FileNotFoundError(f"No sharded checkpoints in {directory}.")
        ok, why = verify_sharded_epoch(directory, epoch, pid)
        if not ok:
            raise HorovodError(
                f"Agreed sharded resume epoch {epoch} (shard {pid}) in "
                f"{directory} failed its CRC check: {why}. Delete or move "
                f"the corrupt shard and resume again.")
    else:
        if not member:
            return template
        if verify:
            ok, why = verify_sharded_epoch(directory, epoch, pid)
            if not ok:
                raise HorovodError(
                    f"Sharded checkpoint epoch {epoch} (shard {pid}) in "
                    f"{directory} failed its integrity check: {why}. Pass "
                    f"epoch=None to resume from the newest complete "
                    f"checkpoint instead.")
    with open(_shard_path(directory, epoch, pid), "rb") as f:
        restored = torch.load(f, map_location="cpu", weights_only=True)
    if template is not None and set(restored) != set(template):
        raise HorovodError(
            f"Sharded checkpoint epoch {epoch} (shard {pid}) in "
            f"{directory} holds {sorted(restored)}, but the state to "
            f"restore has {sorted(template)}.")
    return restored


def latest_sharded_epoch(directory: str, *, verify: bool = True) -> int:
    """Newest sharded-checkpoint epoch whose shard for THIS rank is
    complete (shard files only), or -1. Torn/corrupt shards are skipped
    with a warning, like :func:`latest_epoch`."""
    if not verify:
        epochs = _scan_epochs(directory, _SHARD_FILE_RE)
        return epochs[0] if epochs else -1
    pid = _pid()
    epochs = _verified_epochs(
        directory, _SHARD_FILE_RE,
        lambda e: verify_sharded_epoch(directory, e, pid),
        "sharded checkpoint", limit=1)
    return epochs[0] if epochs else -1


def _agree_newest_common(local_epochs: list[int], group: int, name: str
                         ) -> tuple[int, int]:
    """Allgather each rank's verified-epoch set (the ``_AGREE_K`` newest,
    -1-padded) over the group and return ``(agreed, newest)``: the newest
    epoch present in EVERY rank's set (-1 if none) and the newest epoch ANY
    rank reported (-1 if none) — ``protocol.agree_epochs``. A rank that is
    not a member of ``group`` takes no part and gets its own local answer
    back."""
    local = local_epochs[0] if local_epochs else -1
    vec = torch.full((_AGREE_K,), -1, dtype=torch.int32)
    k = min(len(local_epochs), _AGREE_K)
    vec[:k] = torch.tensor(local_epochs[:k], dtype=torch.int32)
    res = _coll.allgather(vec.to(_state.device()), group=group, name=name)
    if res is None:
        return local, local
    rows = res.cpu().reshape(-1, _AGREE_K).tolist()
    return _proto.agree_epochs([[e for e in row if e >= 0] for row in rows])


def load(directory: str, template: dict | None = None,
         epoch: int | None = None, group: int = 0, *,
         verify: bool = True) -> dict:
    """The checkpoint's state dict (on the CPU), read with
    ``torch.load(weights_only=True)``. ``template`` (what
    :meth:`Trainer.train_state` returns), when given, must have the
    payload's keys. ``group`` is the reference's: once ``hvd.init`` has
    run (or when it is not 0) it must name a group, and it places
    nothing, since the tensors come back on the CPU.

    ``epoch=None`` resumes from the newest COMPLETE epoch (torn/corrupt
    ones are skipped with a warning); an explicit ``epoch`` that fails its
    integrity check raises instead of deserializing garbage
    (``verify=False`` skips that check when the caller has already
    CRC-verified the epoch, as :meth:`Trainer.restore`'s agreement has)."""
    if group != 0 or _state.is_initialized():
        _state.get_group(group)
    if epoch is None:
        epoch = latest_epoch(directory)
        if epoch < 0:
            raise FileNotFoundError(f"No checkpoints in {directory}.")
    elif verify:
        ok, why = verify_epoch(directory, epoch)
        if not ok:
            raise HorovodError(
                f"Checkpoint epoch {epoch} in {directory} failed its "
                f"integrity check: {why}. Pass epoch=None to resume from "
                f"the newest complete checkpoint instead.")
    with open(_path(directory, epoch), "rb") as f:
        restored = torch.load(f, map_location="cpu", weights_only=True)
    if template is not None and set(restored) != set(template):
        raise HorovodError(
            f"Checkpoint epoch {epoch} in {directory} holds "
            f"{sorted(restored)}, but the state to restore has "
            f"{sorted(template)}.")
    return restored


def agree_on_resume_epoch(directory: str, root_rank: int = 0,
                          group: int = 0) -> int:
    """All ranks agree on the newest epoch EVERY rank can load: each rank
    size-verifies the (up to 16) newest epochs on ITS filesystem against
    their manifests, the group takes the newest epoch present in every
    rank's verified set, and each rank then CRC-verifies the ONE agreed
    epoch (same-size bit corruption raises — delete the corrupt file and
    resume again; a silent fallback would need a second agreement round).

    No rank has any loadable checkpoint -> -1 (fresh start). SOME ranks
    have loadable checkpoints but no epoch is loadable on every rank -> a
    loud ``HorovodError`` (the classic misconfiguration is rank-0-only saves
    onto a rank-LOCAL disk). ``root_rank`` is kept for the reference's
    signature; the agreement privileges no rank. A rank that is not a
    member of ``group`` returns its own local scan."""
    local_epochs = _verified_epochs(
        directory, _FILE_RE, lambda e: verify_epoch(directory, e, crc=False),
        "checkpoint", limit=_AGREE_K)
    agreed, newest = _agree_newest_common(
        local_epochs, group, "hvd.agree_resume_epoch")
    if agreed < 0 and newest >= 0:
        raise HorovodError(
            f"No checkpoint epoch in {directory} is loadable on EVERY rank "
            f"(the newest loadable epoch on some rank is {newest}, but at "
            f"least one rank can load none of the reported epochs). With "
            f"rank-local filesystems, rank-0-only saves are unloadable on "
            f"the other ranks: save to shared storage or on every rank. "
            f"Refusing to silently restart from scratch.")
    if newest > agreed >= 0:
        warnings.warn(
            f"Ranks disagree on the resume checkpoint in {directory}: "
            f"the newest loadable epoch reaches {newest} on some rank; "
            f"resuming from epoch {agreed}, the newest epoch loadable on "
            f"every rank.", RuntimeWarning, stacklevel=2)
    if agreed >= 0:
        ok, why = verify_epoch(directory, agreed)
        if not ok:
            raise HorovodError(
                f"Agreed resume epoch {agreed} in {directory} failed its "
                f"CRC check on this rank: {why}. Delete or move the corrupt "
                f"file and resume again.")
    return agreed
