"""EDF — a columnar event-log container (the Parquet/ORC role of the paper):
the port's reader and writer.

Three on-disk layouts share one reader:

EDFV0001 (legacy, whole-column blocks)::

    [8B magic "EDFV0001"] [4B header_len] [header json] [column blocks...]

EDFV0002 (row groups — the out-of-core layout)::

    [8B magic "EDFV0002"] [4B header_len] [header json]
    [group 0: column blocks...] [group 1: column blocks...] ...

The v2 header carries the column schema once (name, dtype, kind
numeric | dict, dictionary tables) plus per-group, per-column byte extents,
so a reader can stream one row group at a time with **column projection** —
only the requested columns' byte ranges of the current group are read and
decoded.  Per-column compression is raw | zlib1 | zlib6 | zlib9.

EDFV0003 keeps the v2 byte layout and adds header-only aggregates per row
group: ``zones`` (per-column min / max / nulls and dictionary presence
bitsets), ``segments`` (the group's case-segment count), ``tail`` (the last
row, the engine's one-row halo) and ``sketch`` (per case segment, the uint32
affine polyhash coefficients of its activity run, ``core.polyhash``).

The file format is the JAX package's: files written there read here and
files written here are byte-identical to that package's for the same
frame.  Decoding runs on the host; each decoded group is copied to the
``device`` the caller names (default ``"cuda"``).  :class:`EDFReader` is
the cached random-access view the query planner uses (zone maps, sketches
and segment counts straight from a v3 header, synthesized once for v1/v2
files), shared through a :class:`ReaderPool`.  :func:`append` grows a
v2/v3 file by whole row groups, atomically (temp file + ``os.replace``),
byte-identical to the JAX package's ``append`` for the same rows.

Every written header leads with a ``stamp``: a content hash of the rest of
the header, placed first so :func:`header_tag` can read it from the file's
first bytes.  ``(st_mtime_ns, st_size, stamp)`` — :func:`file_sig` — is
the staleness signature a cached reader checks before it touches bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import time
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from typing import Iterable, Mapping

import numpy as np

from repro_torch.core.eventframe import ACTIVITY, CASE, EventFrame
from repro_torch.core.polyhash import SKETCH_KEYS, segment_sketch

MAGIC = b"EDFV0001"          # legacy, still readable
MAGIC_V2 = b"EDFV0002"       # row groups, no zone maps — still readable
MAGIC_V3 = b"EDFV0003"
CODECS = ("raw", "zlib1", "zlib6", "zlib9")

# dictionary presence bitsets are only recorded for tables up to this size
MAX_BITSET_TABLE = 4096


def _encode(buf: bytes, codec: str) -> bytes:
    if codec == "raw":
        return buf
    if codec.startswith("zlib"):
        return zlib.compress(buf, int(codec[4:]))
    raise ValueError(f"unknown codec {codec!r}")


def _decode(buf: bytes, codec: str) -> bytes:
    if not buf:
        # zero-byte extent (an empty trailing row group) — nothing to inflate
        return b""
    return buf if codec == "raw" else zlib.decompress(buf)


def _scalar(x):
    """A JSON-safe Python scalar preserving the stored value exactly
    (``float(np.float32)`` is the exact binary64 widening of the float32)."""
    return int(x) if np.issubdtype(np.asarray(x).dtype, np.integer) else float(x)


def _json_safe(obj):
    """Recursively convert numpy scalars/arrays so ``json.dumps`` yields a
    canonical, content-only encoding."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return str(obj)


def _stamp_header(header: dict) -> bytes:
    """Serialize a header with a leading content ``stamp`` key (a hash of
    the canonical header content, emitted first so it can be read from the
    file's first bytes)."""
    body = {k: v for k, v in header.items() if k != "stamp"}
    blob = json.dumps(_json_safe(body), sort_keys=True).encode()
    stamp = hashlib.sha1(blob).hexdigest()[:16]
    return json.dumps({"stamp": stamp, **body}).encode()


_TAG_NEEDLE = b'{"stamp": "'


def header_tag(path: str) -> str:
    """Content tag of a file's header — O(1) bytes for stamped files.

    Every file this module (or the JAX package) writes leads its header
    with a ``stamp`` key, recovered here from the file's first bytes.
    Files from other producers fall back to hashing up to 64 KiB of the
    header itself — still content-sensitive, just not O(1).
    """
    with open(path, "rb") as f:
        head = f.read(12 + 64)
        if len(head) < 12 or head[:8] not in (MAGIC, MAGIC_V2, MAGIC_V3):
            raise ValueError(f"{path!r} is not an EDF file")
        (hlen,) = struct.unpack("<I", head[8:12])
        body = head[12:12 + min(hlen, 64)]
        if body.startswith(_TAG_NEEDLE):
            end = body.find(b'"', len(_TAG_NEEDLE))
            if end > 0:
                return body[len(_TAG_NEEDLE):end].decode()
        f.seek(12)
        return hashlib.sha1(f.read(min(hlen, 65536))).hexdigest()[:16]


def file_sig(path: str) -> tuple[int, int, str]:
    """Staleness signature ``(st_mtime_ns, st_size, header_tag)``.

    The stat pair catches ordinary rewrites cheaply; the header tag
    catches a same-size rewrite landing within a single mtime tick, so a
    cached reader can never serve bytes from a file it did not read.
    """
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size, header_tag(path))


class StaleFileError(ValueError):
    """An EDF file changed on disk under a cached-header reader.

    Subclasses ``ValueError`` so callers that guarded the stat check keep
    working.
    """


def _group_aux(data: Mapping[str, np.ndarray], valid: Mapping[str, np.ndarray],
               tables: Mapping[str, list], lo: int, hi: int) -> dict:
    """Zone maps + segment count + sketch band + tail halo for rows ``[lo, hi)``."""
    zones: dict[str, dict] = {}
    for name in sorted(data):
        arr = data[name][lo:hi]
        z: dict = {"nulls": 0}
        if name in valid:
            z["nulls"] = int((~np.asarray(valid[name][lo:hi], bool)).sum())
        if arr.size:
            z["min"] = _scalar(arr.min())
            z["max"] = _scalar(arr.max())
            table = tables.get(name)
            if table is not None and len(table) <= MAX_BITSET_TABLE:
                present = np.zeros(len(table), bool)
                ids = arr[(arr >= 0) & (arr < len(table))].astype(np.int64)
                present[ids] = True
                z["bits"] = np.packbits(present).tobytes().hex()
        zones[name] = z
    aux: dict = {"zones": zones}
    if hi > lo:
        if CASE in data:
            case = data[CASE][lo:hi]
            aux["segments"] = int((case[1:] != case[:-1]).sum()) + 1
            if ACTIVITY in data:
                sk = segment_sketch(data[ACTIVITY][lo:hi], case)
                aux["sketch"] = {k: sk[k].astype("<u4").tobytes().hex()
                                 for k in SKETCH_KEYS}
        aux["tail"] = {
            "values": {name: _scalar(data[name][hi - 1]) for name in sorted(data)},
            "valid": {name: bool(valid[name][hi - 1]) for name in sorted(valid)},
        }
    return aux


def _host_columns(frame: EventFrame) -> tuple[dict, dict]:
    data = {k: np.ascontiguousarray(v) for k, v in frame.to_numpy().items()}
    valid = {k: v.cpu().numpy() for k, v in frame.valid.items()}
    return data, valid


# ------------------------------------------------------------------ write
def _write_v1(path: str, frame: EventFrame, tables, codec: str) -> dict:
    """Legacy whole-column layout (kept for back-compat round-trips)."""
    cols = []
    blobs = []
    offset = 0
    data, valid = _host_columns(frame)
    for name in sorted(data):
        arr = data[name]
        raw = arr.tobytes()
        enc = _encode(raw, codec)
        meta = {
            "name": name, "dtype": str(arr.dtype), "codec": codec,
            "offset": offset, "nbytes": len(enc), "raw_nbytes": len(raw),
            "kind": "dict" if name in tables else "numeric",
        }
        if name in tables:
            meta["table"] = list(tables[name])
        if name in valid:
            venc = _encode(np.packbits(valid[name]).tobytes(), codec)
            meta["valid_offset"] = offset + len(enc)
            meta["valid_nbytes"] = len(venc)
            blobs.append(enc + venc)
            offset += len(enc) + len(venc)
        else:
            blobs.append(enc)
            offset += len(enc)
        cols.append(meta)
    header = {"nrows": frame.nrows, "columns": cols}
    hjson = _stamp_header(header)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
    return header


def write(path: str, frame: EventFrame, tables: Mapping[str, list] | None = None,
          codec: str = "zlib1", row_group_rows: int | None = None,
          version: int = 3) -> dict:
    """Serialize an EventFrame (from any device). Returns the header.

    ``row_group_rows`` splits the rows into groups of that size (the unit of
    streaming reads); ``None`` writes a single group.  ``version=3`` (the
    default) additionally records per-group zone maps / segment counts /
    sketches / tail halos in the header (byte layout identical to v2);
    ``version=2`` and ``version=1`` emit the older layouts.
    """
    tables = dict(tables or {})
    if version == 1:
        if row_group_rows is not None:
            raise ValueError("row groups need version>=2")
        return _write_v1(path, frame, tables, codec)
    if version not in (2, 3):
        raise ValueError(f"unknown EDF version {version!r}")

    data, valid = _host_columns(frame)
    nrows = frame.nrows
    if row_group_rows is not None and int(row_group_rows) <= 0:
        raise ValueError("row_group_rows must be positive")
    # a zero-row frame still writes one (empty) row group, so the schema,
    # dictionary tables, and validity flags round-trip
    step = max(nrows, 1) if row_group_rows is None else int(row_group_rows)
    bounds = list(range(0, nrows, step)) or [0]

    schema = []
    for name in sorted(data):
        meta = {"name": name, "dtype": str(data[name].dtype), "codec": codec,
                "kind": "dict" if name in tables else "numeric"}
        if name in tables:
            meta["table"] = list(tables[name])
        if name in valid:
            meta["has_valid"] = True
        schema.append(meta)

    groups, blobs = _encode_groups(data, valid, tables, bounds, step, nrows,
                                   codec, version)

    header = {"version": version, "nrows": nrows, "codec": codec,
              "columns": schema, "groups": groups}
    hjson = _stamp_header(header)
    with open(path, "wb") as f:
        f.write(MAGIC_V3 if version >= 3 else MAGIC_V2)
        f.write(struct.pack("<I", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
    return header


def _encode_groups(data, valid, tables, bounds, step, nrows, codec, version,
                   offset: int = 0):
    """Encode rows ``[lo, lo+step)`` per bound into row-group metadata + blobs."""
    groups = []
    blobs = []
    for lo in bounds:
        hi = min(lo + step, nrows)
        gcols = {}
        for name in sorted(data):
            raw = data[name][lo:hi].tobytes()
            enc = _encode(raw, codec)
            ext = {"offset": offset, "nbytes": len(enc), "raw_nbytes": len(raw)}
            blobs.append(enc)
            offset += len(enc)
            if name in valid:
                venc = _encode(np.packbits(valid[name][lo:hi]).tobytes(), codec)
                ext["valid_offset"] = offset
                ext["valid_nbytes"] = len(venc)
                blobs.append(venc)
                offset += len(venc)
            gcols[name] = ext
        group = {"nrows": hi - lo, "columns": gcols}
        if version >= 3:
            group.update(_group_aux(data, valid, tables, lo, hi))
        groups.append(group)
    return groups, blobs


# ----------------------------------------------------------------- append
_APPEND_LOCKS: dict[str, threading.Lock] = {}
_APPEND_LOCKS_GUARD = threading.Lock()


def _append_lock(path: str) -> threading.Lock:
    """The per-path lock every append to ``path`` holds (and the mining
    service's last, locked attempt takes to hold writers off)."""
    key = os.path.abspath(path)
    with _APPEND_LOCKS_GUARD:
        lock = _APPEND_LOCKS.get(key)
        if lock is None:
            lock = _APPEND_LOCKS[key] = threading.Lock()
        return lock


def append(path: str, frame: EventFrame,
           tables: Mapping[str, list] | None = None,
           row_group_rows: int | None = None) -> dict:
    """Append ``frame``'s rows (from any device) to an existing v2/v3 EDF
    file, atomically.

    The new rows become new row groups at the end of the data region;
    the rewritten header (with zone maps / segment counts / tail halos /
    sketch bands for the fresh groups) goes through a temp file +
    ``fsync`` + ``os.replace``, so a concurrent reader observes either the
    old file or the new one — never a torn mix — and a reader holding an
    open handle keeps reading its consistent pre-append snapshot via the
    old inode.  Old groups are copied verbatim: their content signatures
    (:meth:`EDFReader.group_signature`), and therefore every cached
    per-group fold, stay valid.

    Constraints enforced:

    * the frame's schema (column names, dtypes, validity flags) must match
      the file's;
    * dictionary ``tables`` may only *extend* the file's (old ids keep
      their meaning; pass the merged tables when the alphabet grew);
    * the file stays (case, time)-sorted case-major: the appended frame
      must be case-sorted and start at/after the file's tail case.

    ``row_group_rows=None`` writes the whole frame as one new group.
    Returns the new header.  Thread-safe per path within this process;
    cross-process writers need external coordination.
    """
    with _append_lock(path):
        return _append_locked(path, frame, tables, row_group_rows)


def _append_locked(path, frame, tables, row_group_rows):
    header, base = read_header(path)
    version = header["version"]
    if version < 2:
        raise ValueError(
            f"append needs the row-group layout (EDFV0002+); {path!r} is v1")
    if frame.nrows == 0:
        return header
    codec = header.get("codec", "raw")
    old_tables = _tables_from_schema(header)
    schema = {c["name"]: c for c in header["columns"]}
    tables = dict(tables) if tables is not None else dict(old_tables)

    data, valid = _host_columns(frame)

    if set(data) != set(schema):
        raise ValueError(
            f"appended frame columns {sorted(data)} != file schema "
            f"{sorted(schema)}")
    for name, meta in schema.items():
        if str(data[name].dtype) != meta["dtype"]:
            raise ValueError(
                f"column {name!r}: appended dtype {data[name].dtype} != "
                f"file dtype {meta['dtype']}")
        if bool(meta.get("has_valid")) != (name in valid):
            raise ValueError(
                f"column {name!r}: validity flags must match the file")
    for name, old in old_tables.items():
        new = list(tables.get(name, old))
        if new[:len(old)] != list(old):
            raise ValueError(
                f"column {name!r}: dictionary table may only extend the "
                "file's (old ids must keep their meaning)")
        if len(new) > len(old):
            schema[name]["table"] = new
        tables[name] = new

    if CASE in data:
        case = data[CASE]
        if case.size > 1 and bool(np.any(case[1:] < case[:-1])):
            raise ValueError("appended frame must be case-sorted "
                             "(case-major, like the file)")
        tail = (header["groups"][-1].get("tail") or {}).get("values", {}) \
            if header["groups"] else {}
        if CASE in tail and case.size and case[0] < tail[CASE]:
            raise ValueError(
                f"appended rows start at case {int(case[0])} < the file's "
                f"tail case {int(tail[CASE])}; appends must not reopen "
                "earlier cases")

    nrows = frame.nrows
    if row_group_rows is not None and int(row_group_rows) <= 0:
        raise ValueError("row_group_rows must be positive")
    step = nrows if row_group_rows is None else int(row_group_rows)
    data_size = os.path.getsize(path) - base
    groups, blobs = _encode_groups(data, valid, tables,
                                   list(range(0, nrows, step)), step, nrows,
                                   codec, version, offset=data_size)
    header["groups"] = list(header["groups"]) + groups
    header["nrows"] = int(header["nrows"]) + nrows
    hjson = _stamp_header(header)

    tmp = f"{path}.append.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as out, open(path, "rb") as src:
            out.write(MAGIC_V3 if version >= 3 else MAGIC_V2)
            out.write(struct.pack("<I", len(hjson)))
            out.write(hjson)
            src.seek(base)
            shutil.copyfileobj(src, out, 1 << 20)   # old groups, verbatim
            for b in blobs:
                out.write(b)
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return header


# ------------------------------------------------------------------- read
def read_header(path: str) -> tuple[dict, int]:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic not in (MAGIC, MAGIC_V2, MAGIC_V3):
            raise ValueError(f"{path!r} is not an EDF file")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        header.setdefault("version",
                          {MAGIC: 1, MAGIC_V2: 2, MAGIC_V3: 3}[magic])
        return header, 12 + hlen


def num_row_groups_header(header: dict) -> int:
    return len(header["groups"]) if header.get("version", 1) >= 2 else 1


def num_row_groups(path: str) -> int:
    header, _ = read_header(path)
    return num_row_groups_header(header)


def _tables_from_schema(header: dict) -> dict[str, list]:
    return {c["name"]: c["table"] for c in header["columns"] if "table" in c}


def _fetch_group_v2(f, base: int, header: dict, group: dict, want
                    ) -> list[tuple]:
    """Raw (still-compressed) byte extents of one group's projected
    columns — the only step that touches the file handle, kept apart from
    :func:`_decode_group_v2` so a reader holds its I/O lock for the
    seek/read pairs only and decompresses outside it."""
    fetched: list[tuple] = []
    codec = header.get("codec", "raw")
    for meta in header["columns"]:
        name = meta["name"]
        if want is not None and name not in want:
            continue
        ext = group["columns"][name]
        ccodec = meta.get("codec", codec)
        f.seek(base + ext["offset"])
        raw = f.read(ext["nbytes"])
        vraw = None
        if "valid_offset" in ext:
            f.seek(base + ext["valid_offset"])
            vraw = f.read(ext["valid_nbytes"])
        fetched.append((meta, ccodec, raw, vraw))
    return fetched


def _decode_group_v2(fetched: list[tuple], gn: int) -> tuple[dict, dict]:
    """Decompress + deserialize fetched extents to numpy (no file handle)."""
    cols: dict[str, np.ndarray] = {}
    valid: dict[str, np.ndarray] = {}
    for meta, ccodec, raw, vraw in fetched:
        name = meta["name"]
        buf = _decode(raw, ccodec)
        cols[name] = np.frombuffer(buf, dtype=np.dtype(meta["dtype"])).copy()
        if vraw is not None:
            valid[name] = np.unpackbits(
                np.frombuffer(_decode(vraw, ccodec), np.uint8),
                count=gn).astype(bool)
    return cols, valid


def _read_group_numpy(f, base: int, header: dict, group: dict, want
                      ) -> tuple[dict, dict]:
    """Read + decode one v2/v3 group's projected columns to numpy."""
    return _decode_group_v2(_fetch_group_v2(f, base, header, group, want),
                            group["nrows"])


def _read_v1(path: str, columns, device):
    cols, valid, tables = _read_v1_numpy(path, columns)
    return EventFrame.from_numpy(cols, valid, device=device), tables


def _read_v1_numpy(path: str, columns):
    header, base = read_header(path)
    want = set(columns) if columns is not None else None
    cols: dict[str, np.ndarray] = {}
    valid: dict[str, np.ndarray] = {}
    tables: dict[str, list] = {}
    nrows = header["nrows"]
    with open(path, "rb") as f:
        for meta in header["columns"]:
            name = meta["name"]
            if want is not None and name not in want:
                continue
            f.seek(base + meta["offset"])
            raw = _decode(f.read(meta["nbytes"]), meta["codec"])
            cols[name] = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).copy()
            if "valid_offset" in meta:
                f.seek(base + meta["valid_offset"])
                vraw = _decode(f.read(meta["valid_nbytes"]), meta["codec"])
                valid[name] = np.unpackbits(
                    np.frombuffer(vraw, np.uint8), count=nrows).astype(bool)
            if "table" in meta:
                tables[name] = meta["table"]
    return cols, valid, tables


def read(path: str, columns: Iterable[str] | None = None, *, device="cuda"
         ) -> tuple[EventFrame, dict[str, list]]:
    """Load an EventFrame onto ``device``; ``columns`` projects at read time.

    Reads every EDF version; v2/v3 row groups are concatenated on the host.
    """
    header, base = read_header(path)
    if header["version"] == 1:
        return _read_v1(path, columns, device)
    want = set(columns) if columns is not None else None
    parts = []
    with open(path, "rb") as f:
        for group in header["groups"]:
            parts.append(_read_group_numpy(f, base, header, group, want))
    names = parts[0][0] if parts else {}
    cols = {k: np.concatenate([p[0][k] for p in parts]) for k in names}
    valid = {k: np.concatenate([p[1][k] for p in parts])
             for k in (parts[0][1] if parts else {})}
    tables = _tables_from_schema(header)
    if want is not None:
        tables = {k: v for k, v in tables.items() if k in want}
    return EventFrame.from_numpy(cols, valid, device=device), tables


def read_group(path: str, index: int, columns: Iterable[str] | None = None, *,
               device="cuda") -> tuple[EventFrame, dict[str, list]]:
    """Load a single row group onto ``device`` (partial I/O in rows and columns)."""
    header, base = read_header(path)
    if header["version"] == 1:
        if index != 0:
            raise IndexError("EDFV0001 has a single row group")
        return _read_v1(path, columns, device)
    group = header["groups"][index]
    want = set(columns) if columns is not None else None
    with open(path, "rb") as f:
        cols, valid = _read_group_numpy(f, base, header, group, want)
    return (EventFrame.from_numpy(cols, valid, device=device),
            _tables_from_schema(header))


def read_streaming(path: str, columns: Iterable[str] | None = None, *,
                   device="cuda"):
    """Yield ``(EventFrame, tables)`` per row group, each on ``device`` — one
    group resident at a time. EDFV0001 files degrade to a single chunk."""
    header, base = read_header(path)
    if header["version"] == 1:
        yield _read_v1(path, columns, device)
        return
    want = set(columns) if columns is not None else None
    tables = _tables_from_schema(header)
    with open(path, "rb") as f:
        for group in header["groups"]:
            cols, valid = _read_group_numpy(f, base, header, group, want)
            yield EventFrame.from_numpy(cols, valid, device=device), tables


def file_sizes(path: str) -> dict:
    """Per-column compressed/raw byte accounting (Table 2 style).

    ``total`` equals ``os.path.getsize(path)`` exactly: magic + header +
    every column extent *including* the packed validity bitmaps.  ``raw``
    is the uncompressed size of the column data.  ``groups`` is the
    per-row-group breakdown (``nrows`` / ``nbytes`` / per-column bytes)
    the query planner's skip-ratio reporting sums over; v1 files expose
    their single whole-column block as one pseudo-group.
    """
    header, base = read_header(path)
    out: dict = {"total": base, "raw": 0, "header": base}
    groups: list[dict] = []
    if header["version"] == 1:
        gcols = {}
        for c in header["columns"]:
            gcols[c["name"]] = c["nbytes"] + c.get("valid_nbytes", 0)
            out["raw"] += c["raw_nbytes"]
        groups.append({"nrows": header["nrows"],
                       "nbytes": sum(gcols.values()), "columns": gcols})
    else:
        for group in header["groups"]:
            gcols = {}
            for name, ext in group["columns"].items():
                gcols[name] = ext["nbytes"] + ext.get("valid_nbytes", 0)
                out["raw"] += ext["raw_nbytes"]
            groups.append({"nrows": group["nrows"],
                           "nbytes": sum(gcols.values()), "columns": gcols})
    per_col: dict[str, int] = {c["name"]: 0 for c in header["columns"]}
    for g in groups:
        for name, nb in g["columns"].items():
            per_col[name] += nb
        out["total"] += g["nbytes"]
    out.update(per_col)
    out["groups"] = groups
    return out


# ---------------------------------------------------------------- reader
_DECODE_LOCK = threading.Lock()     # EDFReader.decode_ns, from any thread


class EDFReader:
    """Cached-header random access to an EDF file — the query planner's view.

    One header parse serves every ``read_group`` / ``group_meta`` /
    ``group_nbytes`` call.  ``group_meta`` returns the zone-map / segment /
    tail metadata of a row group: for EDFV0003 files straight from the
    header (no data I/O); for v1/v2 files it is synthesized by loading each
    group once on first access (a compatibility fallback — correct pruning,
    but the synthesis pass reads the data it would later skip).

    Reads decode on the host: :meth:`read_group_numpy` returns numpy
    columns (what a read-ahead thread runs — it touches no device), and
    :meth:`read_group` copies them onto ``device``.  ``EDFReader.decode_ns``
    sums, over every reader and thread, the nanoseconds spent in
    :meth:`read_group_numpy` (fetch plus decode; ``repro_torch.trace``'s
    ``edf_decode_ns``).
    """

    decode_ns = 0

    def __init__(self, path: str):
        self.path = path
        self.header, self.base = read_header(path)
        self.version: int = self.header["version"]
        self.tables = _tables_from_schema(self.header)
        self.schema = {c["name"]: c for c in self.header["columns"]}
        self.column_names = tuple(sorted(self.schema))
        self.nrows: int = self.header["nrows"]
        self._synth: list[dict] | None = None   # v1/v2 metadata cache
        self._synth_lock = threading.Lock()     # one synthesis per group
        self._sketch: dict[int, dict] = {}      # decoded/synthesized sketches
        self._gsig: dict[int, str] = {}         # per-group content signatures
        self._file = None                       # persistent handle (lazy)
        self._io_lock = threading.Lock()        # seek/read pairs are shared
        self._pins = 0                          # pin() snapshot holds
        self._close_deferred = False            # close() arrived while pinned
        # the signature must describe the header cached above: if the file
        # was replaced between the two reads, take the header again
        sig = file_sig(path)
        if sig[2] != self.header.get("stamp", sig[2]):
            self.header, self.base = read_header(path)
            sig = file_sig(path)
        self._sig = sig

    # --------------------------------------------------------- file handle
    def _check_sig(self) -> None:
        """Re-validate before touching bytes with no open handle: decoding
        a rewritten file against the cached header would return garbage, so
        it fails loudly instead."""
        if file_sig(self.path) != self._sig:
            raise StaleFileError(
                f"{self.path!r} changed on disk since this reader cached "
                f"its header; get a fresh reader via pooled_reader()")

    def _fh(self):
        """The persistent read handle, reopened transparently if the reader
        was closed (or evicted from a :class:`ReaderPool`) between uses."""
        if self._file is None or self._file.closed:
            self._check_sig()
            self._file = open(self.path, "rb")
        return self._file

    @property
    def closed(self) -> bool:
        return self._file is None or self._file.closed

    def close(self) -> None:
        """Release the file handle.  The reader stays usable: the next read
        reopens the handle.  While a :meth:`pin` is active the close is
        deferred to the last unpin."""
        with self._io_lock:
            if self._pins > 0:
                self._close_deferred = True
                return
            if self._file is not None and not self._file.closed:
                self._file.close()

    @contextmanager
    def pin(self):
        """Hold this reader's snapshot open for the duration of a request:
        opens the handle now (raising :class:`StaleFileError` now rather
        than mid-scan if the file already changed) and defers any
        ``close()`` — including pool eviction — to the last unpin."""
        with self._io_lock:
            self._fh()
            self._pins += 1
        try:
            yield self
        finally:
            with self._io_lock:
                self._pins -= 1
                if self._pins == 0 and self._close_deferred:
                    self._close_deferred = False
                    if self._file is not None and not self._file.closed:
                        self._file.close()

    def __enter__(self) -> "EDFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def num_groups(self) -> int:
        return num_row_groups_header(self.header)

    def _groups(self) -> list[dict]:
        if self.version == 1:
            # present the single whole-column block as one pseudo-group
            return [{"nrows": self.nrows, "columns": {
                c["name"]: c for c in self.header["columns"]}}]
        return self.header["groups"]

    def group_nrows(self, index: int) -> int:
        return self._groups()[index]["nrows"]

    def read_group_numpy(self, index: int,
                         columns: Iterable[str] | None = None
                         ) -> tuple[dict, dict]:
        """One row group's projected columns as numpy ``(columns, valid)``;
        its fetch plus decode time is added to ``EDFReader.decode_ns``."""
        t0 = time.perf_counter_ns()
        out = self._read_group_numpy(index, columns)
        ns = time.perf_counter_ns() - t0
        with _DECODE_LOCK:
            EDFReader.decode_ns += ns
        return out

    def _read_group_numpy(self, index: int, columns) -> tuple[dict, dict]:
        if self.version == 1:
            if index != 0:
                raise IndexError("EDFV0001 has a single row group")
            self._check_sig()           # v1 re-opens per read: same guard
            cols, valid, _ = _read_v1_numpy(self.path, columns)
            return cols, valid
        group = self.header["groups"][index]
        want = set(columns) if columns is not None else None
        # the seek/read pairs on the shared handle must not interleave
        # across threads; decompression happens outside the lock
        with self._io_lock:
            fetched = _fetch_group_v2(self._fh(), self.base, self.header,
                                      group, want)
        return _decode_group_v2(fetched, group["nrows"])

    def read_group(self, index: int, columns: Iterable[str] | None = None, *,
                   device="cuda") -> EventFrame:
        """One row group's projected columns as a frame on ``device``."""
        cols, valid = self.read_group_numpy(index, columns)
        return EventFrame.from_numpy(cols, valid, device=device)

    def group_meta(self, index: int) -> dict:
        """``{"nrows", "zones", "segments"?, "tail"?, "sketch"?}`` for one
        row group."""
        group = self._groups()[index]
        if "zones" in group:
            return group
        # v1/v2 synthesis fallback: serialized so two threads planning over
        # the same pooled reader synthesize each group exactly once
        with self._synth_lock:
            if self._synth is None:
                self._synth = [dict() for _ in range(self.num_groups)]
            if not self._synth[index]:
                data, valid = self.read_group_numpy(index)
                n = group["nrows"]
                meta = {"nrows": n}
                meta.update(_group_aux(data, valid, self.tables, 0, n))
                self._synth[index] = meta
            return self._synth[index]

    def group_sketch(self, index: int) -> dict[str, np.ndarray] | None:
        """Per-segment affine polyhash maps of one row group, as
        ``{"mul1","add1","mul2","add2"}`` uint32 arrays (one entry per case
        segment), or ``None`` when the group has no case/activity columns.

        EDFV0003 files written with the sketch band decode it straight from
        the header; older v3 files (and the v1/v2 synthesis path) fall back
        to a one-time two-column ``(activity, case)`` read per group.
        """
        cached = self._sketch.get(index)
        if cached is not None:
            return cached
        meta = self.group_meta(index)       # v1/v2: synthesizes sketch too
        if "sketch" in meta:
            sk = {k: np.frombuffer(bytes.fromhex(meta["sketch"][k]), "<u4")
                  for k in SKETCH_KEYS}
        elif ("segments" in meta and ACTIVITY in self.schema
                and CASE in self.schema):
            # v3 file from before the sketch band: synthesize lazily from a
            # projected read of just the two id columns
            with self._synth_lock:
                cached = self._sketch.get(index)
                if cached is not None:
                    return cached
                cols, _ = self.read_group_numpy(index, (ACTIVITY, CASE))
                sk = segment_sketch(cols[ACTIVITY], cols[CASE])
        else:
            return None
        self._sketch[index] = sk
        return sk

    def group_signature(self, index: int) -> str:
        """Stable, content-derived signature of one row group.

        Hashes the group's *content* metadata — row count, zone maps,
        segment count, tail halo, variant sketch bands, and per-column
        byte sizes — but never byte offsets, so an append that adds groups
        keeps the signatures of untouched groups (and the state-cache
        entries keyed on them) stable.
        """
        cached = self._gsig.get(index)
        if cached is not None:
            return cached
        meta = self.group_meta(index)
        group = self._groups()[index]
        payload = {
            "nrows": meta.get("nrows"),
            "zones": meta.get("zones"),
            "segments": meta.get("segments"),
            "tail": meta.get("tail"),
            "sketch": meta.get("sketch"),
            "columns": sorted(
                (name, int(ext.get("nbytes", 0)),
                 int(ext.get("valid_nbytes", 0)))
                for name, ext in group.get("columns", {}).items()
                if isinstance(ext, dict)),
        }
        blob = json.dumps(_json_safe(payload), sort_keys=True, default=str)
        sig = hashlib.sha1(blob.encode()).hexdigest()[:16]
        self._gsig[index] = sig
        return sig

    def group_nbytes(self, index: int, columns: Iterable[str] | None = None
                     ) -> int:
        """On-disk bytes of one group restricted to ``columns`` (data +
        validity bitmap extents — what a projected read actually touches)."""
        group = self._groups()[index]
        want = set(columns) if columns is not None else None
        total = 0
        for name, ext in group["columns"].items():
            if want is not None and name not in want:
                continue
            total += ext["nbytes"] + ext.get("valid_nbytes", 0)
        return total


# ------------------------------------------------------------ reader pool
class ReaderPool:
    """Shared cache of :class:`EDFReader` instances, keyed by path.

    Every plan over the same file gets the *same* cached-header reader —
    one header parse, one v1/v2 metadata synthesis, one open handle.
    Entries are validated against :func:`file_sig` on every ``get``, so a
    file rewritten in place is picked up fresh; least-recently-used readers
    beyond ``capacity`` are closed (not invalidated: a plan still holding
    an evicted reader keeps working because :meth:`EDFReader._fh` reopens).
    """

    def __init__(self, capacity: int = 16):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._readers: OrderedDict[str, EDFReader] = OrderedDict()
        self._lock = threading.Lock()   # get/evict race across threads

    def get(self, path: str) -> EDFReader:
        key = os.path.abspath(path)
        sig = file_sig(key)
        evicted = []
        with self._lock:
            reader = self._readers.get(key)
            if reader is not None and reader._sig != sig:
                evicted.append(reader)         # stale: the file changed
                reader = None
            if reader is None:
                reader = EDFReader(key)
                self._readers[key] = reader
            self._readers.move_to_end(key)
            while len(self._readers) > self.capacity:
                _, old = self._readers.popitem(last=False)
                evicted.append(old)
        for old in evicted:                    # close() takes the reader's
            old.close()                        # io lock — never mid-read
        return reader

    def close(self) -> None:
        """Close every pooled handle (readers reopen lazily if reused)."""
        with self._lock:
            readers, self._readers = list(self._readers.values()), \
                OrderedDict()
        for reader in readers:
            reader.close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._readers)


_POOL = ReaderPool()


def reader_pool() -> ReaderPool:
    """The process-wide pool the query planner draws readers from."""
    return _POOL


def pooled_reader(path: str) -> EDFReader:
    """Shared cached-header reader for ``path`` (see :class:`ReaderPool`)."""
    return _POOL.get(path)
