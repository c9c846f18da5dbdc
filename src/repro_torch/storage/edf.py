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
``device`` the caller names (default ``"cuda"``).  Appends, the cached
random-access reader and the reader pool come with the storage slice.
"""
from __future__ import annotations

import hashlib
import json
import struct
import zlib
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


def _read_group_numpy(f, base: int, header: dict, group: dict, want
                      ) -> tuple[dict, dict]:
    """Read + decode one v2/v3 group's projected columns to numpy."""
    cols: dict[str, np.ndarray] = {}
    valid: dict[str, np.ndarray] = {}
    codec = header.get("codec", "raw")
    gn = group["nrows"]
    for meta in header["columns"]:
        name = meta["name"]
        if want is not None and name not in want:
            continue
        ext = group["columns"][name]
        ccodec = meta.get("codec", codec)
        f.seek(base + ext["offset"])
        buf = _decode(f.read(ext["nbytes"]), ccodec)
        cols[name] = np.frombuffer(buf, dtype=np.dtype(meta["dtype"])).copy()
        if "valid_offset" in ext:
            f.seek(base + ext["valid_offset"])
            vraw = _decode(f.read(ext["valid_nbytes"]), ccodec)
            valid[name] = np.unpackbits(np.frombuffer(vraw, np.uint8),
                                        count=gn).astype(bool)
    return cols, valid


def _read_v1(path: str, columns, device):
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
    return EventFrame.from_numpy(cols, valid, device=device), tables


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
