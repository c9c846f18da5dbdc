"""The query server: snapshot-consistent mining over live-ingested files.

:class:`MiningService` answers mining requests over a growing set of EDF
partitions.  Every request mines a *snapshot*: the per-file content
signatures (``storage.edf.file_sig``) captured at request start, pinned
via :meth:`EDFReader.pin` (appends replace the *path*, never the inode,
so a pinned handle keeps reading its consistent pre-append view), and
re-validated after the mine.  If an append raced the request — the only
way a multi-round collect could have mixed two file generations — the
request retries against the new snapshot; the final attempt takes the
per-path append locks, briefly holding writers off, so a request can
never livelock under continuous ingest.  Each response carries the claim
(``snapshot``): exactly which file states the result was mined from,
which is what the parity tests re-mine.

Every request mines on the service's device (``device="cuda"`` unless
the caller names the CPU).  Kernel capacity dims are *pinned*: the
service sizes ``num_cases`` to a power-of-two high-water mark
(``case_capacity``), not the live case count.  Per-case result arrays carry identity values past the live
count, and — because the state-cache spec fingerprint includes the
capacity dims — cached per-group folds stay valid across appends: a
re-collect after an append only decodes the fresh groups.

HTTP layer: a ``ThreadingHTTPServer`` JSON API —

=============  ====  ====================================================
``/health``    GET   liveness + file set + cache counters
``/collect``   both  one verb (``verb=``, ``engine=``, verb kwargs)
``/profile``   both  every registered verb, one fused pass
``/window``    both  sliding windows (``by=``, ``size=``, ``step=``,
                     ``verb=``)
``/explain``   both  the plan + engine choice + cache probe, as text
=============  ====  ====================================================

GET query parameters are JSON-coerced (``min_count=2`` arrives as an
int); POST bodies are JSON objects with the same keys.  Env knobs:
``REPRO_SERVICE_DIR`` ``REPRO_SERVICE_HOST`` ``REPRO_SERVICE_PORT``
``REPRO_SERVICE_CASE_CAPACITY`` ``REPRO_SERVICE_ATTEMPTS`` (see
:func:`main`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping

import numpy as np
import torch

from repro_torch.storage import edf as _edf


class ServiceError(Exception):
    """A request-level failure with an HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def to_jsonable(obj):
    """Recursively convert a mining result (tensors on any device, numpy
    arrays, namedtuple models, dataclass reports, fingerprint-keyed dicts)
    into plain JSON types.  Floats pass through Python's repr round-trip,
    so ``json.dumps(to_jsonable(a)) == json.dumps(to_jsonable(b))`` is a
    bitwise-faithful equality on numeric payloads."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "_asdict"):                         # namedtuple models
        return {"_type": type(obj).__name__,
                **{k: to_jsonable(v) for k, v in obj._asdict().items()}}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"_type": type(obj).__name__,
                **{f.name: to_jsonable(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, Mapping):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(v) for v in obj]
    return repr(obj)


def _round_capacity(n: int, floor: int = 1024) -> int:
    cap = max(int(floor), 1)
    while cap < n:
        cap *= 2
    return cap


class MiningService:
    """Snapshot-consistent mining over a live file set (module docstring).

    ``source`` is a directory of ``part_*.edf`` partitions (re-listed per
    request, so partitions appearing later are picked up), an explicit
    path list, or an :class:`~repro_torch.service.ingest.Ingestor` (its
    output partitions are served).  ``device`` is where every request
    mines (the card unless the caller names the CPU).
    """

    def __init__(self, source, case_capacity: int | None = None,
                 max_attempts: int | None = None, device="cuda"):
        from .ingest import Ingestor

        self._ingestor = source if isinstance(source, Ingestor) else None
        self._dir = source if isinstance(source, str) else None
        self._fixed = (tuple(str(p) for p in source)
                       if not (self._ingestor or self._dir) else None)
        self.case_floor = (case_capacity if case_capacity is not None
                           else int(os.environ.get(
                               "REPRO_SERVICE_CASE_CAPACITY") or 1024))
        self.max_attempts = (max_attempts if max_attempts is not None
                             else int(os.environ.get(
                                 "REPRO_SERVICE_ATTEMPTS") or 4))
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.device = device
        self._case_cap = 0
        self._cap_lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.retries = 0

    # ---------------------------------------------------------- snapshot
    def paths(self) -> list[str]:
        if self._ingestor is not None:
            return self._ingestor.paths
        if self._dir is not None:
            try:
                names = sorted(n for n in os.listdir(self._dir)
                               if n.startswith("part_") and
                               n.endswith(".edf"))
            except FileNotFoundError:
                return []
            return [os.path.join(self._dir, n) for n in names]
        return list(self._fixed)

    def _capacity(self, actual: int) -> int:
        with self._cap_lock:
            if actual > self._case_cap:
                self._case_cap = _round_capacity(actual, self.case_floor)
            return self._case_cap

    def _mine(self, fn):
        """Run ``fn(dataset)`` against one consistent snapshot.

        Optimistic attempts pin the pooled readers (holding the snapshot's
        inodes open) and re-validate every file signature afterwards; a
        raced append triggers a retry.  The last attempt holds the
        per-path append locks instead — guaranteed consistent, so
        continuous ingest can delay a request but never starve it.
        Returns ``(payload, claim)`` where the claim names the exact file
        states mined.
        """
        from repro_torch.dataset import open_dataset

        last_exc = None
        for attempt in range(self.max_attempts):
            if attempt:
                self.retries += 1
            locked = attempt == self.max_attempts - 1
            paths = self.paths()
            if not paths:
                raise ServiceError(503, "no partitions available yet")
            try:
                with contextlib.ExitStack() as stack:
                    if locked:
                        for p in sorted(paths):
                            stack.enter_context(_edf._append_lock(p))
                    readers = [_edf.pooled_reader(p) for p in paths]
                    for r in readers:
                        stack.enter_context(r.pin())
                    sig0 = tuple(r._sig for r in readers)
                    cap = self._capacity(open_dataset(
                        paths, device=self.device).num_cases)
                    ds = open_dataset(paths, num_cases=cap,
                                      device=self.device)
                    claim = {
                        "files": [{"path": p, "nrows": r.nrows,
                                   "groups": r.num_groups, "tag": r._sig[2]}
                                  for p, r in zip(paths, readers)],
                        "rows": sum(r.nrows for r in readers),
                        "num_cases": cap,
                        "num_activities": ds.num_activities,
                    }
                    try:
                        payload = fn(ds)
                    except _edf.StaleFileError as e:
                        last_exc = e
                        continue
                    except Exception:
                        # re-raise real errors; swallow only failures that
                        # raced an append (the snapshot moved underneath)
                        if locked or self._sigs(paths) == sig0:
                            raise
                        last_exc = RuntimeError(
                            "an append raced the mine")
                        continue
                    if locked or self._sigs(paths) == sig0:
                        return payload, claim
                    last_exc = RuntimeError(
                        "the snapshot advanced during the mine")
            except (_edf.StaleFileError, FileNotFoundError) as e:
                last_exc = e            # reader resolution raced an append
                continue
        raise ServiceError(503, "could not mine a consistent snapshot after "
                                f"{self.max_attempts} attempts: {last_exc}")

    @staticmethod
    def _sigs(paths):
        try:
            return tuple(_edf.file_sig(p) for p in paths)
        except (OSError, ValueError):
            return None

    # ---------------------------------------------------------- requests
    def collect(self, verb: str | None = None, engine: str = "auto",
                **kwargs) -> dict:
        """One verb over the current snapshot (per-request engine)."""
        if not verb:
            raise ServiceError(400, "collect needs verb=<registered verb>")
        self.requests += 1
        (res, claim) = self._mine(
            lambda ds: ds.collect(verb, engine=engine, **kwargs))
        return {"verb": verb, "engine": res.engine, "snapshot": claim,
                "report": to_jsonable(res.report),
                "result": to_jsonable(res.result)}

    def profile(self, engine: str = "auto", **kwargs) -> dict:
        """Every registered verb in one fused pass (the dashboard call)."""
        self.requests += 1
        (res, claim) = self._mine(
            lambda ds: ds.profile(engine=engine, **kwargs))
        return {"verbs": list(res.verbs), "engine": res.engine,
                "snapshot": claim, "report": to_jsonable(res.report),
                "results": to_jsonable(res.results)}

    def window(self, verb: str | None = None, by: str = "groups",
               size=None, step=None, engine: str = "auto", **kwargs) -> dict:
        """Sliding-window mining over the snapshot (``Dataset.window``)."""
        if not verb or size is None:
            raise ServiceError(400, "window needs verb= and size= "
                                    "(by=groups|time, optional step=)")
        self.requests += 1
        size_v = float(size) if by == "time" else int(size)
        step_v = None if step is None else (
            float(step) if by == "time" else int(step))
        (res, claim) = self._mine(
            lambda ds: ds.window(by, size=size_v, step=step_v)
                         .collect(verb, **kwargs))
        return {"verb": verb, "by": by, "size": size_v,
                "step": step_v if step_v is not None else size_v,
                "snapshot": claim, "bounds": to_jsonable(res.bounds),
                "report": to_jsonable(res.report),
                "results": to_jsonable(res.results)}

    def graph(self, query: str | None = None, engine: str = "auto",
              **kwargs) -> dict:
        """The compiled process graph, optionally with one graph query
        (``query=reachability|bottleneck_paths|node_centrality``) answered
        over the *same* snapshot — graph and query come from one ``_mine``
        so the pair is guaranteed consistent."""
        self.requests += 1
        queries = ("reachability", "bottleneck_paths", "node_centrality")
        if query is not None and query not in queries:
            raise ServiceError(400, f"unknown graph query {query!r}; "
                                    f"one of {list(queries)}")
        timed = bool(kwargs.pop("timed", False))

        def fn(ds):
            res = ds.collect("graph", engine=engine, timed=timed)
            g = res.result
            lab = ds._activity_labels()
            if lab is not None:
                g = g.with_labels(lab)
            out = {"graph": {"freq": to_jsonable(g.freq),
                             "perf": to_jsonable(g.perf),
                             "labels": list(g.node_labels()),
                             "source": g.source, "sink": g.sink},
                   "engine": res.engine}
            if query is not None:
                out["query"] = to_jsonable(
                    ds.collect(query, engine=engine, **kwargs).result)
            return out

        payload, claim = self._mine(fn)
        payload["snapshot"] = claim
        return payload

    def explain(self, verb: str = "dfg", **_ignored) -> dict:
        """The facade's ``explain`` text for one verb, plus the claim."""
        self.requests += 1
        (text, claim) = self._mine(lambda ds: ds.explain(verb))
        return {"verb": verb, "snapshot": claim, "explain": text}

    def health(self) -> dict:
        """Liveness: the current file set and cache counters (never 503)."""
        from repro_torch.query.statecache import state_cache

        files = []
        for p in self.paths():
            try:
                header, _ = _edf.read_header(p)
                files.append({"path": p, "nrows": header["nrows"],
                              "groups": len(header.get("groups", ()))})
            except (OSError, ValueError):
                files.append({"path": p, "nrows": None, "groups": None})
        sc = state_cache()
        out = {"ok": True, "files": files,
               "rows": sum(f["nrows"] or 0 for f in files),
               "uptime_s": time.time() - self.started,
               "requests": self.requests, "retries": self.retries,
               "case_capacity": self._case_cap,
               "state_cache": {"entries": len(sc), "bytes": sc.bytes,
                               "hits": sc.hits, "misses": sc.misses}}
        if self._ingestor is not None:
            out["ingested"] = self._ingestor.ingested
        return out


# ------------------------------------------------------------- HTTP layer
def _coerce(value: str):
    """JSON-coerce one query-string value (numbers, bools, lists pass
    through as their JSON types; everything else stays a string)."""
    try:
        return json.loads(value)
    except (json.JSONDecodeError, TypeError):
        return value


class _Handler(BaseHTTPRequestHandler):
    """Routes requests to the bound :class:`MiningService` (see serve())."""

    service: MiningService              # bound by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:       # keep the server quiet
        pass

    def do_GET(self) -> None:
        self._route()

    def do_POST(self) -> None:
        self._route()

    def _route(self) -> None:
        parsed = urllib.parse.urlparse(self.path)
        params = {k: _coerce(v[-1])
                  for k, v in urllib.parse.parse_qs(parsed.query).items()}
        if self.command == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            if body:
                try:
                    payload = json.loads(body)
                    if not isinstance(payload, dict):
                        raise ValueError("body must be a JSON object")
                    params.update(payload)
                except (json.JSONDecodeError, ValueError) as e:
                    return self._send(400, {"ok": False, "error": str(e)})
        route = parsed.path.rstrip("/") or "/health"
        handlers = {"/health": self.service.health,
                    "/collect": self.service.collect,
                    "/profile": self.service.profile,
                    "/window": self.service.window,
                    "/graph": self.service.graph,
                    "/explain": self.service.explain}
        fn = handlers.get(route)
        if fn is None:
            return self._send(404, {"ok": False, "error":
                                    f"unknown endpoint {route!r}; one of "
                                    f"{sorted(handlers)}"})
        t0 = time.perf_counter()
        try:
            out = fn(**params) if route != "/health" else fn()
        except ServiceError as e:
            return self._send(e.status, {"ok": False, "error": str(e)})
        except (ValueError, KeyError, TypeError) as e:
            return self._send(400, {"ok": False, "error":
                                    f"{type(e).__name__}: {e}"})
        except Exception as e:          # pragma: no cover - defensive
            return self._send(500, {"ok": False, "error":
                                    f"{type(e).__name__}: {e}"})
        out = {"ok": True, **out}
        out["elapsed_us"] = (time.perf_counter() - t0) * 1e6
        self._send(200, out)

    def _send(self, status: int, body: dict) -> None:
        blob = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)


def serve(source, host: str | None = None, port: int | None = None,
          **service_kwargs) -> ThreadingHTTPServer:
    """Bind the JSON API over ``source`` (dir | paths | Ingestor |
    MiningService).  Returns the bound threaded server — call
    ``serve_forever()`` (or run it on a thread; handler threads are
    daemons).  ``port=0`` picks a free port (``server_address[1]``)."""
    service = (source if isinstance(source, MiningService)
               else MiningService(source, **service_kwargs))
    handler = type("BoundHandler", (_Handler,), {"service": service})
    host = host if host is not None else \
        os.environ.get("REPRO_SERVICE_HOST", "127.0.0.1")
    port = port if port is not None else \
        int(os.environ.get("REPRO_SERVICE_PORT") or 8099)
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def main(argv=None) -> None:
    """CLI: serve a partition directory, optionally ingesting a batch
    directory on a background thread while serving::

        python -m repro_torch.service.server --dir /data/parts \\
            --ingest-from /data/batches --port 8099

    Requests mine on the card.
    """
    from .ingest import Ingestor

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--dir", default=os.environ.get("REPRO_SERVICE_DIR"),
                    help="partition directory to serve (REPRO_SERVICE_DIR)")
    ap.add_argument("--ingest-from", default=None,
                    help="batch directory to tail into --dir while serving")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    if not args.dir:
        ap.error("--dir (or REPRO_SERVICE_DIR) is required")
    source: object = args.dir
    ingestor = None
    if args.ingest_from:
        ingestor = Ingestor(args.dir, args.ingest_from).start()
        source = ingestor
    httpd = serve(source, args.host, args.port)
    print(f"repro_torch mining service on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]} (dir={args.dir})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        if ingestor is not None:
            ingestor.stop()


if __name__ == "__main__":
    main()
