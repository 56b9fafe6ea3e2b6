"""Crash-consistent snapshots of the paged engine's whole state, and
restore after a process death — port of ``repro/serve/snapshot.py``.

  * ``save_snapshot(engine, path)`` writes everything the next tick
    depends on to one file: the target's and the draft's ``PagedKVCache``
    pools verbatim (bf16 or f32 rows, or int8 rows and their f32 scale
    pools), block tables, lengths, owned lists, free list, refcounts,
    pending copy-on-write reservations, the retained pool (tokens, pages,
    stamps, hits), the seized set and its release schedule, every slot,
    the request table, the queue order, both generators' states and the
    tick and stat counters.  The write is atomic (temp file, ``fsync``,
    ``os.replace``): a crash mid-write leaves the previous snapshot, and
    a truncated or damaged file fails its CRC32 instead of restoring.

  * ``restore_engine(engine, path)`` puts a freshly built engine (the
    caller's weights: a snapshot carries state, not parameters) into the
    snapshotted tick.  The pools are copied in place onto the engine's
    device; every table row is marked dirty, so the engine's dirty-row
    sync rebuilds the device table and length mirrors (the draft's too)
    on the next tick; the live prefix index and the retained digest keys
    are recomputed from the restored token histories.  Greedy decode is
    deterministic and the restore verbatim, so the continuation is the
    uninterrupted run's, token for token.

  * The header's ``fingerprint`` names every knob that fixes the shapes
    of the state, as the JAX package's does, plus ``package``: a snapshot
    of the other package fails with a typed ``SnapshotMismatchError``
    naming it (its RNG state is a threefry key, this one a torch
    generator's), never deep inside a restore.

The container is the JAX package's, byte for byte, so either package's
``load_snapshot`` decodes the other's file (all integers
little-endian)::

    MAGIC "RPSNAP01" | u64 header_len | header JSON | body
    body = state JSON (state_len bytes) | raw array bytes, manifest order
    header = {version, tick, state_len, body_len, body_crc32, fingerprint}

Arrays are raw bytes with their dtype name and shape in the manifest.
numpy has no bfloat16 without ``ml_dtypes``, which the port does not
need: a bf16 pool is written as its 16-bit patterns under the dtype name
``"bfloat16"`` (as the JAX package writes it) and decoded into a
``torch.bfloat16`` tensor; every other array decodes into numpy.  No
pickle and no ``torch.save``.

``snapshot_path`` / ``list_snapshots`` / ``latest_snapshot`` /
``prune_snapshots`` keep ``snap-<tick>.bin`` files in a directory;
``latest_snapshot`` skips files that fail validation, so recovery falls
back to the newest snapshot that checks out.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.cache import (PagedKVCache, RetainedPrefix,
                                     prefix_digests)

MAGIC = b"RPSNAP01"
VERSION = 1
PACKAGE = "repro_torch"

# PagedKVCache counters carried so a restored engine's stats continue
# across the restart (none affects the output)
_CACHE_COUNTERS = (
    "cow_copies", "cow_bytes", "cow_dispatches", "shared_pages",
    "retained_hits", "retained_hit_tokens", "retained_reclaimed_pages",
    "retained_dropped")

# engine counters restored verbatim (the same argument)
_ENGINE_COUNTERS = (
    "steps_run", "ticks", "_idle", "no_progress_ticks", "_next_rid",
    "preemptions", "recompute_tokens", "rejected", "cancelled",
    "deadline_exceeded", "quarantines", "dropped_grants", "tokens_out",
    "tokens_appended", "spec_proposed", "spec_accepted",
    "spec_trunc_tokens", "draft_dispatches", "verify_dispatches",
    "shared_tokens", "joins", "stalls", "table_upload_bytes",
    "forced_upload_bytes", "prefill_upload_bytes", "upload_bytes",
    "snapshots_written")


class SnapshotError(RuntimeError):
    """Base of the snapshot failures."""


class SnapshotCorruptError(SnapshotError):
    """Bad magic, a truncated file or a checksum mismatch: the file is no
    usable snapshot (a crash mid-write lands here, never in a partial
    restore)."""


class SnapshotMismatchError(SnapshotError):
    """The snapshot is intact but was taken from an engine whose
    shape-determining config (or package) differs from the target's."""


# -- fingerprint --------------------------------------------------------------

def fingerprint(engine) -> Dict[str, Any]:
    """The JAX package's fingerprint fields, with its values, and
    ``package``.  Two engines with equal fingerprints can exchange
    snapshots; anything else is a typed mismatch at load time."""
    acfg, scfg = engine.model.cfg, engine.cfg
    return {
        "arch": acfg.name,
        "n_layers": acfg.n_layers,
        "d_model": acfg.d_model,
        "n_heads": acfg.n_heads,
        "n_kv_heads": acfg.n_kv_heads,
        "d_head": acfg.d_head,
        "vocab_size": acfg.vocab_size,
        "kv_dtype": acfg.kv_dtype,
        "max_batch": scfg.max_batch,
        "max_seq": scfg.max_seq,
        "page_size": engine.kv.page,
        "max_blocks": engine.kv.max_blocks,
        "num_pages": engine.kv.num_pages,
        "spec_k": scfg.spec_k,
        "prefill_lane": bool(scfg.prefill_lane),
        "temperature": scfg.temperature,
        "seed": scfg.seed,
        "draft_arch": engine.draft_model.cfg.name
        if engine.draft_model is not None else None,
        "package": PACKAGE,
    }


# -- array codec --------------------------------------------------------------

def _put(arrays: Dict[str, Tuple[str, np.ndarray]], name: str, arr) -> None:
    """Stage ``arr`` (a numpy array, or a torch tensor, which comes to the
    host here) as (dtype name, contiguous host array)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:        # numpy has no bfloat16
            t = t.view(torch.int16)
        host = t.cpu().numpy()
    else:
        host = np.ascontiguousarray(arr)
        dtype = host.dtype.name
    arrays[name] = (dtype, host)


def _encode_arrays(arrays):
    """(manifest, [raw byte views]) in insertion order."""
    manifest: List[Dict[str, Any]] = []
    blobs = []
    for name, (dtype, host) in arrays.items():
        raw = host.reshape(-1).view(np.uint8)
        manifest.append({"name": name, "dtype": dtype,
                         "shape": list(host.shape), "nbytes": raw.size})
        blobs.append(raw)
    return manifest, blobs


def _decode_arrays(manifest, raw: memoryview) -> Dict[str, Any]:
    """name -> writable numpy array, or CPU ``torch.bfloat16`` tensor."""
    out: Dict[str, Any] = {}
    off = 0
    for ent in manifest:
        n = int(ent["nbytes"])
        if off + n > len(raw):
            raise SnapshotCorruptError(
                f"array {ent['name']!r} runs past the body "
                f"({off + n} > {len(raw)} bytes)")
        chunk = raw[off:off + n]
        shape = [int(d) for d in ent["shape"]]
        if ent["dtype"] == "bfloat16":
            out[ent["name"]] = torch.frombuffer(
                bytearray(chunk), dtype=torch.bfloat16).reshape(shape) \
                if n else torch.empty(shape, dtype=torch.bfloat16)
        else:
            dt = np.dtype(ent["dtype"])
            out[ent["name"]] = np.frombuffer(
                chunk, dtype=dt, count=n // dt.itemsize).copy().reshape(shape)
        off += n
    return out


# -- cache (de)serialization ---------------------------------------------------

def _pool_names(kv: PagedKVCache) -> Tuple[str, ...]:
    return ("k", "v", "k_scale", "v_scale") if kv.quantized else ("k", "v")


def _cache_state(kv: PagedKVCache, tag: str, arrays) -> Dict[str, Any]:
    for name in _pool_names(kv):
        _put(arrays, f"{tag}.{name}", getattr(kv, name))
    for name in ("table", "length", "refcount", "retained_refs"):
        _put(arrays, f"{tag}.{name}", getattr(kv, name))
    return {
        "quantized": bool(kv.quantized),
        "owned": [[int(p) for p in o] for o in kv.owned],
        "free": [int(p) for p in kv.free],
        "seized": sorted(int(p) for p in kv.seized),
        # pending copies restore verbatim: their source pages are saved
        # before the flush, so the flush after a restore makes the copies
        # the dead process never issued
        "pending_cow": [[int(x) for x in t] for t in kv._pending_cow],
        "retain_clock": int(kv._retain_clock),
        # digest keys are recomputed from the tokens on restore
        "retained": [{"tokens": [int(t) for t in e.tokens],
                      "pages": [int(p) for p in e.pages],
                      "stamp": int(e.stamp), "hits": int(e.hits)}
                     for e in kv.retained],
        "counters": {c: int(getattr(kv, c)) for c in _CACHE_COUNTERS},
    }


def _restore_cache(kv: PagedKVCache, tag: str, state: Dict[str, Any],
                   arrays: Dict[str, Any]) -> None:
    if bool(state["quantized"]) != bool(kv.quantized):
        raise SnapshotMismatchError(
            f"{tag}: snapshot quantized={state['quantized']} but engine "
            f"pool quantized={kv.quantized}")
    pools = {}
    for name in _pool_names(kv):
        arr = arrays[f"{tag}.{name}"]
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        pool = getattr(kv, name)
        if t.dtype != pool.dtype or t.shape != pool.shape:
            raise SnapshotMismatchError(
                f"{tag}.{name}: snapshot holds {t.dtype} {list(t.shape)}, "
                f"the engine's pool is {pool.dtype} {list(pool.shape)}")
        pools[name] = t
    for name, t in pools.items():        # onto the engine's device, in place
        getattr(kv, name).copy_(t)
    kv.table = arrays[f"{tag}.table"].astype(np.int32)
    kv.length = arrays[f"{tag}.length"].astype(np.int32)
    kv.refcount = arrays[f"{tag}.refcount"].astype(np.int32)
    kv.retained_refs = arrays[f"{tag}.retained_refs"].astype(np.int32)
    kv.owned = [[int(p) for p in o] for o in state["owned"]]
    kv.free = [int(p) for p in state["free"]]
    kv.seized = set(int(p) for p in state["seized"])
    kv._pending_cow = [tuple(int(x) for x in t)
                       for t in state["pending_cow"]]
    kv._retain_clock = int(state["retain_clock"])
    kv.retained = []
    kv._retained_keys = {}
    for ent in state["retained"]:
        toks = [int(t) for t in ent["tokens"]]
        digests = prefix_digests(toks, kv.page)
        entry = RetainedPrefix(
            tokens=toks, pages=[int(p) for p in ent["pages"]],
            keys=[(j + 1, d) for j, d in enumerate(digests)],
            stamp=int(ent["stamp"]), hits=int(ent["hits"]))
        kv.retained.append(entry)
        for key in entry.keys:
            kv._retained_keys.setdefault(key, []).append(entry)
    for c in _CACHE_COUNTERS:
        setattr(kv, c, int(state["counters"][c]))
    # every device mirror row is rebuilt by the engine's dirty-row sync on
    # the next tick: a restore has no upload path of its own
    kv.dirty = set(range(kv.table.shape[0]))


# -- engine (de)serialization --------------------------------------------------

def _engine_state(engine, arrays) -> Dict[str, Any]:
    _put(arrays, "engine.feed", engine._feed)
    _put(arrays, "engine.generator", engine.generator.get_state())
    if engine.dkv is not None:
        _put(arrays, "engine.dgenerator", engine._dgen.get_state())
    return {
        "slots": [{"rid": int(s.rid), "forced": [int(t) for t in s.forced],
                   "out": [int(t) for t in s.out],
                   "history": [int(t) for t in s.history],
                   "budget": int(s.budget), "served": int(s.served),
                   "prompt_left": int(s.prompt_left),
                   "active": bool(s.active)}
                  for s in engine.slots],
        "queue": [int(r.rid) for r in engine.queue],
        "reqs": {str(rid): {"prompt": [int(t) for t in r.prompt],
                            "max_new_tokens": int(r.max_new_tokens),
                            "deadline_tick": int(r.deadline_tick),
                            "emitted": [int(t) for t in r.emitted],
                            "preempts": int(r.preempts)}
                 for rid, r in engine._reqs.items()},
        "status": {str(rid): s.value for rid, s in engine.status.items()},
        "reject_reason": {str(rid): r
                          for rid, r in engine.reject_reason.items()},
        "results": {str(rid): [int(t) for t in toks]
                    for rid, toks in engine.results.items()},
        "quarantined": {str(i): int(t)
                        for i, t in engine._quarantined.items()},
        "squeezed": [[int(until), [int(p) for p in pages]]
                     for until, pages in engine._squeezed],
        "fault_counts": {str(k): int(v)
                         for k, v in engine.fault_counts.items()},
        "counters": {c: int(getattr(engine, c))
                     for c in _ENGINE_COUNTERS},
    }


def _set_generator(gen: torch.Generator, state: np.ndarray,
                   name: str) -> None:
    try:
        gen.set_state(torch.from_numpy(np.ascontiguousarray(state,
                                                            np.uint8)))
    except RuntimeError as e:            # another device's generator
        raise SnapshotMismatchError(
            f"{name}: the snapshot's generator state ({state.size} bytes) "
            f"does not fit this engine's {gen.device} generator: {e}") from e


def _restore_engine_state(engine, state: Dict[str, Any],
                          arrays: Dict[str, Any]) -> None:
    from repro_torch.serve.engine import Request, RequestStatus, _Slot

    engine._feed = arrays["engine.feed"].astype(np.int32)
    _set_generator(engine.generator, arrays["engine.generator"],
                   "engine.generator")
    if engine.dkv is not None:
        if "engine.dgenerator" not in arrays:
            raise SnapshotMismatchError(
                "speculative engine cannot restore from a snapshot "
                "without a draft generator state (spec_k mismatch)")
        _set_generator(engine._dgen, arrays["engine.dgenerator"],
                       "engine.dgenerator")
    engine.slots = [
        _Slot(rid=s["rid"], forced=list(s["forced"]), out=list(s["out"]),
              history=list(s["history"]), budget=s["budget"],
              served=s["served"], prompt_left=s["prompt_left"],
              active=s["active"])
        for s in state["slots"]]
    engine._reqs = {
        int(rid): Request(int(rid), np.asarray(r["prompt"], np.int32),
                          r["max_new_tokens"],
                          deadline_tick=r["deadline_tick"],
                          emitted=list(r["emitted"]),
                          preempts=r["preempts"])
        for rid, r in state["reqs"].items()}
    engine.queue = [engine._reqs[rid] for rid in state["queue"]]
    engine.status = {int(rid): RequestStatus(v)
                     for rid, v in state["status"].items()}
    engine.reject_reason = {int(rid): r
                            for rid, r in state["reject_reason"].items()}
    engine.results = {int(rid): list(toks)
                      for rid, toks in state["results"].items()}
    engine._quarantined = {int(i): int(t)
                           for i, t in state["quarantined"].items()}
    engine._squeezed = [(int(until), [int(p) for p in pages])
                        for until, pages in state["squeezed"]]
    engine.fault_counts = {str(k): int(v)
                           for k, v in state["fault_counts"].items()}
    engine._drop_slots = set()
    engine._poison_slots = set()
    for c in _ENGINE_COUNTERS:
        setattr(engine, c, int(state["counters"][c]))
    # the live prefix index is derived state: rebuilt from the restored
    # histories as the ticks that built it would have built it
    engine._pindex.__init__()
    if engine.cfg.prefix_sharing:
        for i, slot in enumerate(engine.slots):
            if slot.active and slot.history:
                engine._pindex.add(i, slot.history)


# -- container ----------------------------------------------------------------

def save_snapshot(engine, path: str) -> str:
    """Write ``engine``'s state to ``path`` atomically (temp file, fsync,
    rename): a reader sees the previous complete snapshot or the new one,
    never a partial write.  The body's CRC32 runs over the pieces as they
    are written, with no copy of the body.  Returns ``path``."""
    arrays: Dict[str, Tuple[str, np.ndarray]] = {}
    state: Dict[str, Any] = {
        "engine": _engine_state(engine, arrays),
        "kv": _cache_state(engine.kv, "kv", arrays),
        "dkv": _cache_state(engine.dkv, "dkv", arrays)
        if engine.dkv is not None else None,
    }
    manifest, blobs = _encode_arrays(arrays)
    state["arrays"] = manifest
    state_b = json.dumps(state).encode("utf-8")
    crc = zlib.crc32(state_b)
    for raw in blobs:
        crc = zlib.crc32(raw, crc)
    header = {
        "version": VERSION,
        "tick": int(engine.ticks),
        "state_len": len(state_b),
        "body_len": len(state_b) + sum(raw.size for raw in blobs),
        "body_crc32": crc & 0xFFFFFFFF,
        "fingerprint": fingerprint(engine),
    }
    header_b = json.dumps(header).encode("utf-8")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(header_b).to_bytes(8, "little"))
        f.write(header_b)
        f.write(state_b)
        for raw in blobs:
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _read_container(path: str) -> Tuple[Dict[str, Any], memoryview]:
    """(header, body) with magic, lengths and checksum validated: a
    truncation or a flipped bit lands in ``SnapshotCorruptError`` here,
    never in a partly applied restore."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotError(f"cannot read snapshot {path}: {e}") from e
    if data[:len(MAGIC)] != MAGIC:
        raise SnapshotCorruptError(
            f"{path}: bad magic {data[:len(MAGIC)]!r} (want {MAGIC!r})")
    off = len(MAGIC)
    if len(data) < off + 8:
        raise SnapshotCorruptError(f"{path}: truncated before header")
    hlen = int.from_bytes(data[off:off + 8], "little")
    off += 8
    if len(data) < off + hlen:
        raise SnapshotCorruptError(f"{path}: truncated header")
    try:
        header = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise SnapshotCorruptError(f"{path}: header is not JSON") from e
    if header.get("version") != VERSION:
        raise SnapshotMismatchError(
            f"{path}: snapshot version {header.get('version')} != "
            f"reader version {VERSION}")
    body = memoryview(data)[off + hlen:]
    if len(body) != int(header["body_len"]):
        raise SnapshotCorruptError(
            f"{path}: body is {len(body)} bytes, header says "
            f"{header['body_len']} (truncated write)")
    crc = zlib.crc32(body) & 0xFFFFFFFF
    if crc != int(header["body_crc32"]):
        raise SnapshotCorruptError(
            f"{path}: body checksum {crc:#010x} != recorded "
            f"{int(header['body_crc32']):#010x}")
    return header, body


def load_header(path: str) -> Dict[str, Any]:
    """The validated header alone: the launcher's fast-fail compares
    ``header['fingerprint']`` before it builds an engine."""
    header, _ = _read_container(path)
    return header


def load_snapshot(path: str):
    """(header, state, arrays), decoded and checksum-verified."""
    header, body = _read_container(path)
    state_len = int(header["state_len"])
    try:
        state = json.loads(bytes(body[:state_len]))
    except ValueError as e:
        raise SnapshotCorruptError(f"{path}: state is not JSON") from e
    arrays = _decode_arrays(state["arrays"], body[state_len:])
    return header, state, arrays


def restore_engine(engine, path: str):
    """Restore ``engine`` (freshly built, with the snapshotting engine's
    configs) to the snapshotted tick.  The fingerprints must match
    exactly; pools, tables, slots, queue, requests, generator states and
    counters come back verbatim; the derived indexes (live prefix index,
    retained digest keys, device mirrors) are rebuilt.  Returns
    ``engine``."""
    header, state, arrays = load_snapshot(path)
    want, got = fingerprint(engine), header["fingerprint"]
    if want != got:
        diff = {k: (got.get(k), want.get(k))
                for k in set(want) | set(got)
                if got.get(k) != want.get(k)}
        raise SnapshotMismatchError(
            f"{path}: snapshot fingerprint does not match this engine "
            f"(snapshot vs engine): {diff}")
    _restore_cache(engine.kv, "kv", state["kv"], arrays)
    if engine.dkv is not None:
        if state["dkv"] is None:
            raise SnapshotMismatchError(
                f"{path}: engine has a draft pool but the snapshot "
                "carries none")
        _restore_cache(engine.dkv, "dkv", state["dkv"], arrays)
    _restore_engine_state(engine, state["engine"], arrays)
    engine._last_snapshot_tick = int(header["tick"])
    return engine


# -- snapshot directories ------------------------------------------------------

def snapshot_path(snap_dir: str, tick: int) -> str:
    return os.path.join(snap_dir, f"snap-{tick:08d}.bin")


def list_snapshots(snap_dir: str) -> List[str]:
    """Every snapshot file in ``snap_dir``, oldest tick first."""
    try:
        names = os.listdir(snap_dir)
    except OSError:
        return []
    return [os.path.join(snap_dir, n) for n in sorted(names)
            if n.startswith("snap-") and n.endswith(".bin")]


def latest_snapshot(snap_dir: str) -> Optional[str]:
    """The newest snapshot that passes validation, or None.  A truncated
    or damaged newest file is skipped: recovery falls back to the
    previous complete snapshot instead of failing."""
    for path in reversed(list_snapshots(snap_dir)):
        try:
            _read_container(path)
        except SnapshotError:
            continue
        return path
    return None


def prune_snapshots(snap_dir: str, keep: int) -> List[str]:
    """Remove all but the newest ``keep`` snapshots; returns the removed
    paths.  ``keep`` < 1 keeps everything."""
    removed: List[str] = []
    if keep < 1:
        return removed
    snaps = list_snapshots(snap_dir)
    for path in snaps[:-keep] if len(snaps) > keep else []:
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed
