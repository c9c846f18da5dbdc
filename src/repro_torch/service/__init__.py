"""The live mining service: append-only ingestion + a concurrent query API,
mining on the card.

Three layers over the ``Dataset`` facade:

* ``storage.edf.append`` / ``Dataset.append`` — atomic append-only
  growth of EDFV0003 files (new row groups, header rewritten through
  ``os.replace``; old groups byte-identical, so the per-group state
  cache stays hot);
* :class:`~repro_torch.service.ingest.Ingestor` — a resilient batch ETL
  loop tailing a source (directory or callable) into partitioned
  EDFV0003 files, with a persisted skip-index, retry-with-backoff, and
  crash-safe resume (host-side: it writes files and mines nothing);
* :class:`~repro_torch.service.server.MiningService` / :func:`serve` — a
  threaded ``http.server`` JSON API (``/collect`` ``/profile``
  ``/window`` ``/graph`` ``/explain`` ``/health``) over the shared reader
  pool and state/result caches, each request mining a snapshot-consistent
  view on the card (``python -m repro_torch.service.server``).
"""
from .ingest import Ingestor, directory_source
from .server import MiningService, ServiceError, serve, to_jsonable

__all__ = ["Ingestor", "directory_source", "MiningService", "ServiceError",
           "serve", "to_jsonable"]
