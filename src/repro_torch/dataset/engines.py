"""Engine dispatch for the ``Dataset`` facade — the first cost-based plan.

Schedules over one merge algebra (``core.engine``'s group states): a verb
whose kernel defines a ``stitch`` folds work units independently and
``merge_tree``-s the unit states, so the engines below differ only in how
they cut the stream into units —

* **eager** — one unit: ``edf.read`` every file whole onto the dataset's
  device, apply the filter chain there (the same masks the planner pushes
  down), fold once.  No per-group overhead: the fastest path when the
  surviving data is small and pruning would not skip much.
* **streaming** — one unit per row group: ``repro_torch.query`` pruned
  scans refute groups from zone maps before any I/O, and
  ``execute_grouped`` folds each surviving group into a cacheable
  :class:`~repro_torch.core.engine.GroupState` (``query.statecache``) — a
  re-collect after an append only decodes the *fresh* groups and
  re-merges the rest from the cache.  Kernels without a stitch (the
  order-sensitive float accumulators: ``sojourn_times`` /
  ``performance_dfg`` / ``stats``) and plans with case-level predicates
  keep the sequential carry-threaded scan — same results, no caching.
* **sharded** — one unit per shard of a single-controller mesh
  (``repro_torch.distributed``; shard *i* on ``cuda:(i % device_count)``,
  or every shard on the CPU): verbs with a distributed lowering
  (``KernelSpec.sharded_state``) gather the pruned stream on the host, cut
  it into equal shards, run one kernel update a shard from the previous
  shard's tail rows and ``psum`` the states; every *other* mergeable verb
  shards as a literal merge-tree instance
  (``distributed.query.merge_tree_sharded`` — contiguous spans of the
  pruned stream folded independently, states merged, finalized once).

Every engine runs on the dataset's ``device`` (default ``"cuda"``): the
verbs' kernels launch there, or raise; nothing falls back to the CPU.
The front door (:func:`collect`, :func:`collect_many`) then delivers a
card answer into page-locked host memory (:func:`_deliver`: one stream
sync a request, blocks reused through PyTorch's caching host allocator),
so the client's ``x.cpu().numpy()`` is a zero-copy wrap.

Whole :class:`CollectResult`/:class:`CollectManyResult` values are also
memoized per process, keyed by the plan fingerprint, each file's content
signature, and the dataset's device type with the lowering it resolves to
— re-collecting an untouched dataset performs **zero** reads, touching any
file invalidates only its entry, and a result mined on one device is
never served to a collect on another (``REPRO_RESULT_CACHE=0`` disables).

``engine="auto"`` picks between eager and streaming from *header metadata
only*: total on-disk bytes per group accounting, the fraction of
groups/bytes the zone maps already refute, and — for case-level
predicates — the per-group dictionary presence bitsets of EDFV0003 zones
(a group whose bitset lacks the wanted activity contributes no phase-one
hits, so its bytes are *estimated* skipped).  The decision is a
**calibrated cost model**: per-byte and per-group costs fitted by least
squares (:func:`fit_calibration`) to a dispatch sweep of both engines on
the card (``chip_smoke.py``'s ``dataset_path``); refit to the local
machine via ``REPRO_DATASET_CALIBRATION=/path/to/sweep.json``.  The
sharded decision keeps one environment-tunable threshold:

* ``REPRO_DATASET_SHARD_ROWS`` (default 2M) — above this many surviving
  rows, shard when more than one card is attached (a CPU dataset counts
  one device).

Every lowering returns bitwise-identical results, so a wrong guess costs
time, never correctness.

**Fused collection** (:func:`collect_many`) resolves several verbs into
one :func:`~repro_torch.core.engine.compose_specs` fused spec and drives
the chosen engine ONCE: one pruned scan (columns = the union of the
member requirements, ``mask_exact`` = their conjunction), one eager
load, or one sharded pass over the distinct distributed states — each
verb's result bitwise equal to its separate ``collect`` call.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import backend as _backend
from repro_torch.core import engine as _engine
from repro_torch.core.eventframe import CASE, EventFrame

SHARD_ROWS = int(os.environ.get("REPRO_DATASET_SHARD_ROWS", 2_000_000))

ENGINES = ("auto", "eager", "streaming", "sharded")

def spec_for(verb: str) -> _engine.KernelSpec:
    return _engine.kernel_spec(verb)


def _spec_fp(verb: str, dims: _engine.Dims, kwargs: Mapping) -> tuple:
    from repro_torch.query.statecache import spec_fingerprint

    return spec_fingerprint(verb, dims, dict(kwargs))


def _lowering(device) -> tuple:
    """(device type, the lowering it resolves to) — the device half of
    every memo key: a CPU result is never served to a CUDA collect."""
    dev = torch.device(device).type
    return dev, _backend.resolve(dev)


# ------------------------------------------------------- result memoization
RESULT_CACHE_ENV = "REPRO_RESULT_CACHE"
_RESULT_CAP = 128
_RESULTS: OrderedDict = OrderedDict()
_RESULTS_LOCK = threading.Lock()


def file_signatures(paths) -> tuple:
    """Per-file ``(path, st_mtime_ns, st_size, header_tag, num_groups)`` —
    the invalidation unit of both the result memo and the reader pool.

    The stat pair is the cheap fast-moving part; the header content tag
    (``storage.edf.file_sig``) plus the row-group count close the
    pathological hole: a same-size rewrite landing within one mtime tick
    can no longer alias the signature of the file it replaced, so a
    memoized result can never be served for bytes that were never read.
    """
    from repro_torch.storage.edf import pooled_reader

    sigs = []
    for p in paths:
        r = pooled_reader(p)
        sigs.append((p, *r._sig, r.num_groups))
    return tuple(sigs)


def _memo_key(dataset, extra) -> tuple | None:
    """Content key of one collect over a file-backed dataset, or ``None``
    when memoization does not apply (in-memory frame, disabled, or a file
    is unreadable).  ``extra`` carries the verb + engine + kwargs."""
    if not dataset.is_files or os.environ.get(RESULT_CACHE_ENV, "1") == "0":
        return None
    try:
        sigs = file_signatures(dataset.paths)
    except OSError:
        return None
    return (sigs, repr(dataset.steps), dataset.projection,
            dataset.hint_activities, dataset.hint_cases,
            _lowering(dataset.device), extra)


def _memo_get(key):
    """The memoized result of ``key``, or ``None``; counts a file
    dataset's lookups in ``_memo_get.hits`` / ``.misses``."""
    if key is None:
        return None
    with _RESULTS_LOCK:
        hit = _RESULTS.get(key)
        if hit is not None:
            _RESULTS.move_to_end(key)
            _memo_get.hits += 1
        else:
            _memo_get.misses += 1
        return hit


_memo_get.hits = 0
_memo_get.misses = 0


def _memo_put(key, value):
    if key is None:
        return
    with _RESULTS_LOCK:
        _RESULTS[key] = value
        _RESULTS.move_to_end(key)
        while len(_RESULTS) > _RESULT_CAP:
            _RESULTS.popitem(last=False)


def clear_result_cache() -> None:
    """Drop every memoized collect result (tests; the per-group state
    cache is separate — ``repro_torch.query.statecache.state_cache().clear()``)."""
    with _RESULTS_LOCK:
        _RESULTS.clear()


# ------------------------------------------------------------ cost model
@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Plan-time I/O estimate from zone maps (no data bytes touched for
    EDFV0003 files; v1/v2 files pay their one-off metadata synthesis)."""

    bytes_total: int
    bytes_est: int          # bytes the pruned scan would read
    rows_total: int
    rows_est: int
    groups_total: int
    groups_est: int

    @property
    def selectivity(self) -> float:
        """Estimated surviving-bytes fraction (1.0 = nothing refuted)."""
        return self.bytes_est / self.bytes_total if self.bytes_total else 1.0


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted dispatch costs, in microseconds (see module docstring).

    ``eager ~= eager_a + eager_b * bytes_total`` (the whole projected
    extent — eager decodes everything), ``streaming ~= stream_a +
    stream_b * bytes_est + stream_g * groups_est`` (only surviving
    bytes/groups; the intercept is the planner's fixed cost).
    """

    eager_a: float
    eager_b: float      # us per byte of the full projected extent
    stream_a: float
    stream_b: float     # us per surviving byte the pruned scan reads
    stream_g: float     # us per surviving row group (per-group overhead)
    source: str = "builtin"

    def eager_us(self, est: CostEstimate) -> float:
        return self.eager_a + self.eager_b * est.bytes_total

    def streaming_us(self, est: CostEstimate) -> float:
        return (self.stream_a + self.stream_b * est.bytes_est
                + self.stream_g * est.groups_est)


# least squares (fit_calibration) over the dispatch sweep of chip_smoke.py's
# dataset_path: the L1 log (14 row groups of 524,288 rows), the DFG over
# case bands of 1, 2, 4, 7 and 14 groups through both engines, synchronized,
# median of 3, on an NVIDIA H100 80GB HBM3, 700.00 W (PyTorch 2.11.0+cu128);
# refit to the local machine via REPRO_DATASET_CALIBRATION
DEFAULT_CALIBRATION = Calibration(
    eager_a=6.0688202004365555e-09, eager_b=0.05943236283382861,
    stream_a=40200.09474929091, stream_b=0.02103033200329218, stream_g=0.0)


def fit_calibration(bench: Mapping) -> Calibration:
    """Least-squares fit of the dispatch cost model to a sweep dict (its
    ``sweep`` points carry measured ``us_eager`` / ``us_streaming``
    against the bytes and groups each engine touched).

    The sweep varies selectivity over one dataset, so ``bytes_total`` is
    constant and the eager fit is rank-deficient; the min-norm solution
    puts the cost on the slope — eager cost extrapolates with file size,
    which is the behaviour dispatch needs.  The streaming fit tries
    ``a + b*bytes + g*groups`` and falls back to bytes-only when
    collinearity drives any coefficient negative (a negative per-byte
    cost would invert decisions off-sweep)."""
    pts = [p for p in bench.get("sweep", ())
           if "us_eager" in p and "us_streaming" in p]
    if not pts:
        raise ValueError("no usable sweep points to fit a calibration from")
    bt = np.array([p["bytes_total"] for p in pts], float)
    br = np.array([p["bytes_read"] for p in pts], float)
    gr = np.array([p.get("groups_total", 0) - p.get("groups_skipped", 0)
                   for p in pts], float)
    ue = np.array([p["us_eager"] for p in pts], float)
    us = np.array([p["us_streaming"] for p in pts], float)
    one = np.ones_like(br)
    ea, eb = np.linalg.lstsq(np.stack([one, bt], 1), ue, rcond=None)[0]
    coef = np.linalg.lstsq(np.stack([one, br, gr], 1), us, rcond=None)[0]
    if len(pts) < 3 or (coef < 0).any():
        sa, sb = np.linalg.lstsq(np.stack([one, br], 1), us, rcond=None)[0]
        coef = np.array([sa, sb, 0.0])
    return Calibration(max(float(ea), 0.0), max(float(eb), 0.0),
                       max(float(coef[0]), 0.0), max(float(coef[1]), 0.0),
                       max(float(coef[2]), 0.0), source="fit")


_CALIBRATION: Calibration | None = None


def calibration() -> Calibration:
    """The active calibration: fitted from the JSON file named by
    ``REPRO_DATASET_CALIBRATION`` if set, else the built-in coefficients
    (cached after first resolution)."""
    global _CALIBRATION
    if _CALIBRATION is None:
        path = os.environ.get("REPRO_DATASET_CALIBRATION", "")
        if path:
            import json

            with open(path) as f:
                fitted = fit_calibration(json.load(f))
            _CALIBRATION = dataclasses.replace(fitted, source=path)
        else:
            _CALIBRATION = DEFAULT_CALIBRATION
    return _CALIBRATION


def estimate(dataset) -> CostEstimate:
    """Zone-map selectivity estimate for the dataset's current plan.

    Row-level predicates skip groups their zone proofs refute; case-level
    predicates skip groups whose dictionary presence bitsets show the
    wanted value cannot occur (``phase1_prove == NONE``) — an *estimate*:
    a kept case straddling such a group still forces the real scan to
    read it, so the scan may read slightly more than estimated, never
    less correctly."""
    with trace.span("scan.plan"):
        return _estimate(dataset)


def _estimate(dataset) -> CostEstimate:
    from repro_torch.query.expr import NONE, CasePredicate
    from repro_torch.query.optimize import compile_plan

    bt = be = rt = re_ = gt = ge = 0
    for plan in dataset.plan().per_file():
        ph = compile_plan(plan, True)
        exprs = list(ph.proves)
        preds = [s for s in ph.steps if isinstance(s, CasePredicate)]
        for g in range(ph.reader.num_groups):
            n = ph.reader.group_nrows(g)
            if n == 0:
                continue
            nbytes = ph.reader.group_nbytes(g, ph.read_columns)
            gt += 1
            rt += n
            bt += nbytes
            if any(ph.proves[i][g] == NONE for i in exprs):
                continue            # provably refuted: the scan skips it
            if preds and ph.metas is not None and any(
                    p.phase1_prove(ph.metas[g]) == NONE for p in preds):
                continue            # presence bitsets: no case hit here
            ge += 1
            re_ += n
            be += nbytes
    return CostEstimate(bt, be, rt, re_, gt, ge)


def choose(dataset, spec: _engine.KernelSpec,
           est: CostEstimate | None, n_devices: int | None = None) -> str:
    """The cost-based engine decision (see module docstring)."""
    if not dataset.is_files:
        return "eager"
    if est is None:
        est = estimate(dataset)
    if n_devices is None:
        n_devices = _device_count(dataset.device)
    if (spec.sharded_state is not None and n_devices > 1
            and est.rows_est >= SHARD_ROWS):
        return "sharded"
    cal = calibration()
    if cal.streaming_us(est) <= cal.eager_us(est):
        return "streaming"
    return "eager"


# --------------------------------------------------------------- engines
def eager_frame(dataset) -> EventFrame:
    """Load everything onto the dataset's device, apply the filter chain
    there.

    Uses the *same* predicate masks and phase-one kernels the planner
    pushes down, so eager == streaming bitwise by construction.
    """
    from repro_torch.core import ops
    from repro_torch.query.expr import CasePredicate, bind_schema
    from repro_torch.storage import edf

    with trace.span("filter"):
        if dataset.is_files:
            from repro_torch.core.eventframe import concat_frames
            from repro_torch.query.exec import check_homogeneous

            check_homogeneous(dataset._readers)  # fail like streaming would
            frame = concat_frames([edf.read(p, device=dataset.device)[0]
                                   for p in dataset.paths])
        else:
            frame = dataset.frame
        tables = dataset.tables
        for step in dataset.steps:
            if isinstance(step, CasePredicate):
                with trace.span("filter.case"):
                    resolved = step.resolve(tables)
                    kernel = resolved.phase1_kernel(dataset.num_cases)
                    with trace.span("filter.case.phase1"):
                        hits = _engine.run_single(kernel, frame)
                    with trace.span("filter.case.keep"):
                        keep = resolved.finalize_keep(hits)
                        seg, _ = ops.segment_ids_sorted(frame[CASE])
                        keep = trace.to_device(np.asarray(keep), frame.device)
                        frame = ops.proj(frame, keep[seg.long()])
            else:
                with trace.span("filter.rows"):
                    bound = bind_schema(step, dataset.schema)
                    frame = ops.proj(frame, bound.mask(frame))
        if dataset.projection is not None:
            frame = frame.select(dataset.projection)
        return frame


def _device_count(device) -> int:
    """Devices a dataset's shards spread over: the cards for a CUDA
    dataset, one for a CPU dataset."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def _num_shards(num_shards, device) -> int:
    if num_shards is not None:
        return max(int(num_shards), 1)
    return max(_device_count(device), 1)


def _mesh(num_shards, device):
    from repro_torch.distributed.mesh import mesh_for

    return mesh_for(_num_shards(num_shards, device), device)


def _sharded(dataset, spec: _engine.KernelSpec, dims, num_shards, **kwargs):
    from repro_torch.distributed.query import (merge_tree_sharded,
                                               query_sharded_multi)

    if not dataset.is_files:
        raise ValueError("engine='sharded' needs a file-backed dataset")
    if spec.sharded_state is None:
        # no bespoke distributed state — but a mergeable kernel shards as
        # a merge-tree instance over contiguous spans of the pruned stream
        kernel = spec.make(dims, **kwargs)
        if not _engine.mergeable(kernel):
            raise ValueError(
                f"verb {spec.name!r} has no exact distributed lowering "
                f"(order-sensitive state, no stitch); use "
                f"engine='streaming' or 'eager'")
        return merge_tree_sharded(dataset.plan(columns=spec.columns),
                                  kernel, _num_shards(num_shards,
                                                      dataset.device),
                                  device=dataset.device)
    # same projection/column validation as the other engines (the driver
    # re-projects the scan to its own (activity, case) columns anyway)
    plan = dataset.plan(columns=spec.columns)
    out, report = query_sharded_multi(plan, (spec.sharded_state,),
                                      dims.num_activities,
                                      _mesh(num_shards, dataset.device),
                                      method=kwargs.get("method", "auto"),
                                      num_cases=dims.num_cases)
    return spec.from_sharded(out[spec.sharded_state], **kwargs), report


def _sharded_many(dataset, specs: Mapping[str, _engine.KernelSpec],
                  fused: _engine.KernelSpec, dims, num_shards,
                  verb_kwargs: Mapping[str, dict], common: dict):
    from repro_torch.distributed.query import (merge_tree_sharded,
                                               query_sharded_multi)

    if not dataset.is_files:
        raise ValueError("engine='sharded' needs a file-backed dataset")
    if fused.sharded_state is None:
        # same merge-tree fallback as single-verb collects: a fused kernel
        # stitches iff every member does
        kernel = fused.make(dims, verb_kwargs=dict(verb_kwargs), **common)
        if not _engine.mergeable(kernel):
            bad = sorted(v for v, s in specs.items()
                         if s.sharded_state is None and
                         not _engine.mergeable(s.make(dims, **{
                             **common, **dict(verb_kwargs.get(v, {}))})))
            raise ValueError(
                f"fused collection has no exact distributed lowering: verbs "
                f"{bad} (order-sensitive state, no stitch); drop them or "
                f"use engine='streaming' or 'eager'")
        results, report = merge_tree_sharded(
            dataset.plan(columns=fused.columns), kernel,
            _num_shards(num_shards, dataset.device), device=dataset.device)
        return dict(results), report
    # verbs sharing a distributed state (dfg + alpha, discovery +
    # heuristics) dedupe: each distinct state is mined once from the one
    # gathered stream, then every verb finalizes from its state
    states = tuple(dict.fromkeys(s.sharded_state for s in specs.values()))
    plan = dataset.plan(columns=fused.columns)
    out, report = query_sharded_multi(plan, states, dims.num_activities,
                                      _mesh(num_shards, dataset.device),
                                      method=common.get("method", "auto"),
                                      num_cases=dims.num_cases)
    results = {v: s.from_sharded(out[s.sharded_state],
                                 **{**common, **dict(verb_kwargs.get(v, {}))})
               for v, s in specs.items()}
    return results, report


# ------------------------------------------------------------ scan counts
_SCAN_LOCK = threading.Lock()
SCAN_FIELDS = ("groups_read", "groups_cached", "groups_skipped", "rows_read",
               "bytes_read")


def _count_scan(report) -> None:
    """Add a streaming collect's ``ScanReport`` to ``_count_scan.<field>``
    for each of ``SCAN_FIELDS`` (``repro_torch.trace``'s ``scan_*``)."""
    with _SCAN_LOCK:
        for f in SCAN_FIELDS:
            setattr(_count_scan, f,
                    getattr(_count_scan, f) + getattr(report, f))


_count_scan.__dict__.update(dict.fromkeys(SCAN_FIELDS, 0))


# -------------------------------------------------------------- delivery
_DELIVER_LOCK = threading.Lock()


def _deliver(answer):
    """``answer`` with each CUDA tensor replaced by its own copy in
    page-locked host memory: ``torch.empty(..., pin_memory=True)`` from
    PyTorch's caching host allocator, filled by ``copy_(non_blocking=True)``
    on the current stream, then one synchronize of each source device's
    stream.  A tensor held twice in one answer is copied once.  An answer
    that holds no CUDA tensor (a CPU dataset's) is returned as it is.

    A pinned block goes back to the allocator's cache when the client
    drops the answer holding it, and serves a later answer of its size
    class without pinning new pages; the cache keeps its high-water mark
    (blocks rounded up to a power of two) until
    ``torch.accelerator.empty_host_cache()`` (``torch._C._host_emptyCache()``
    in builds that lack it) hands the unused blocks back.
    The result memo holds up to ``_RESULT_CAP`` answers, so a file dataset
    keeps at most that many answers' blocks pinned beside the client's.
    Counts the tensors and bytes copied."""
    copies: dict[int, tuple] = {}

    def pinned(t):
        if not t.is_cuda:
            return t
        if id(t) not in copies:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            copies[id(t)] = (t, host.copy_(t, non_blocking=True))
        return copies[id(t)][1]

    with trace.span("collect.deliver"):
        if not any(t.is_cuda for t in _engine.tensor_leaves(answer)):
            return answer
        out = _engine.map_tensors(pinned, answer)
        for dev in {t.device for t, _ in copies.values()}:
            torch.cuda.current_stream(dev).synchronize()
    with _DELIVER_LOCK:
        _deliver.answer_tensors += len(copies)
        _deliver.answer_d2h_bytes += sum(t.numel() * t.element_size()
                                         for t, _ in copies.values())
    return out


_deliver.answer_tensors = 0
_deliver.answer_d2h_bytes = 0


# ------------------------------------------------------------- front door
@dataclasses.dataclass(frozen=True)
class CollectResult:
    """A verb's result plus how it ran (I/O report is None for eager).

    On a card dataset the answer's tensors are in page-locked host memory;
    ``.to(device)`` continues on the card.  A CPU dataset's are its own."""

    result: Any
    report: Any | None
    engine: str
    verb: str
    estimate: CostEstimate | None = None


def _fold_eager(kernel, frame):
    """Eager = the one-unit schedule of the merge algebra: fold the whole
    in-memory frame as a single group state and finalize it.  For kernels
    without a stitch this degenerates to ``run_single`` — both are
    ``finalize(update(init, frame))``, bitwise."""
    with trace.span("fold"):
        if _engine.mergeable(kernel):
            chunks = [frame] if frame.nrows else []
            return _engine.finalize_group(
                kernel, _engine.fold_group(kernel, chunks, frame.device))
        # a zero-row dataset still finalizes cleanly (like run_streaming)
        return (_engine.run_single(kernel, frame) if frame.nrows
                else kernel.finalize(*kernel.init(frame.device)))


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")


def collect(dataset, verb: str, *, engine: str = "auto",
            num_shards: int | None = None, prefetch: int | None = None,
            **kwargs) -> CollectResult:
    """Resolve the verb through the kernel registry, pick an engine, run
    on the dataset's device, deliver the answer to the host
    (:func:`_deliver`)."""
    _check_engine(engine)
    with trace.span("collect"):
        memo_key = _memo_key(dataset, (
            "collect", verb, engine, num_shards,
            # auto's choice moves with the fitted costs — key them so a
            # recalibration is never served a stale decision
            calibration() if engine == "auto" else None,
            tuple(sorted((k, repr(v)) for k, v in kwargs.items()))))
        hit = _memo_get(memo_key)
        if hit is not None:
            return hit
        out = _deliver(_collect(dataset, verb, engine, num_shards, prefetch,
                                kwargs))
        _memo_put(memo_key, out)
        return out


def _collect(dataset, verb, engine, num_shards, prefetch, kwargs
             ) -> CollectResult:
    spec = spec_for(verb)
    with trace.span("facade.dims"):
        dims = _engine.Dims(dataset.num_activities, dataset.num_cases)
    est = None
    if engine == "auto":
        est = estimate(dataset) if dataset.is_files else None
        engine = choose(dataset, spec, est)
    if engine == "eager":
        if dataset.is_files:
            dataset.plan(columns=spec.columns)  # same projection/column
            # validation (and error) the streaming engine would raise
        kernel = _engine.traced(spec.make(dims, **kwargs), verb)
        result = _fold_eager(kernel, eager_frame(dataset))
        return CollectResult(result, None, "eager", verb, est)
    if engine == "sharded":
        result, report = _sharded(dataset, spec, dims, num_shards, **kwargs)
        return CollectResult(result, report, "sharded", verb, est)
    # streaming: per-group states through the cache when the kernel
    # stitches (and the plan is row-level), else the sequential scan
    from repro_torch.query.exec import (execute, execute_grouped,
                                        grouped_eligible)

    with trace.span("scan"):
        kernel = _engine.traced(spec.make(dims, **kwargs), verb)
        with trace.span("scan.plan"):
            plan = dataset.plan(columns=spec.columns)
        if grouped_eligible(kernel, dataset.steps):
            result, report = execute_grouped(plan, kernel,
                                             _spec_fp(verb, dims, kwargs),
                                             device=dataset.device)
        else:
            result, report = execute(plan, kernel, prefetch=prefetch,
                                     device=dataset.device)
    _count_scan(report)
    return CollectResult(result, report, "streaming", verb, est)


@dataclasses.dataclass(frozen=True)
class CollectManyResult:
    """Per-verb results of one fused pass, plus how it ran.

    ``results[verb]`` is bitwise equal to ``collect(dataset, verb).result``
    under the same engine; ``report`` is the single scan's I/O accounting
    (None for eager).  Indexable: ``res["dfg"]``.  On a card dataset the
    answer's tensors are in page-locked host memory; ``.to(device)``
    continues on the card.
    """

    results: dict
    report: Any | None
    engine: str
    verbs: tuple
    estimate: CostEstimate | None = None

    def __getitem__(self, verb: str):
        return self.results[verb]


def collect_many(dataset, verbs: Iterable[str], *, engine: str = "auto",
                 num_shards: int | None = None, prefetch: int | None = None,
                 verb_kwargs: Mapping[str, dict] | None = None,
                 **common) -> CollectManyResult:
    """Run several registered verbs in ONE pass over the dataset.

    The verbs fuse into a single :func:`~repro_torch.core.engine.compose_specs`
    spec — one kernel, one scan whose projection is the union of the
    member column requirements — and dispatch like any other verb:
    ``engine="auto"`` applies the calibrated cost model to the fused
    spec, ``"sharded"`` mines each distinct distributed state once from
    one gathered stream.  Every registered verb is pruning-exact (``variants`` replays
    skipped groups from header sketches), so the fused scan always skips
    refuted groups whatever the member mix.

    ``verb_kwargs={"alpha": {"min_count": 2}}`` routes per-verb options;
    other keyword arguments (e.g. ``method=``) apply to every member.
    """
    verbs = tuple(verbs)
    _check_engine(engine)
    if len(set(verbs)) != len(verbs):
        raise ValueError(f"duplicate verbs in collect_many: {list(verbs)}")
    vk = dict(verb_kwargs or {})
    with trace.span("collect"):
        memo_key = _memo_key(dataset, (
            "collect_many", verbs, engine, num_shards,
            calibration() if engine == "auto" else None,
            tuple(sorted((v, tuple(sorted((k, repr(x))
                                          for k, x in kw.items())))
                         for v, kw in vk.items())),
            tuple(sorted((k, repr(v)) for k, v in common.items()))))
        hit = _memo_get(memo_key)
        if hit is not None:
            return hit
        out = _deliver(_collect_many(dataset, verbs, engine, num_shards,
                                     prefetch, vk, common))
        _memo_put(memo_key, out)
        return out


def _collect_many(dataset, verbs, engine, num_shards, prefetch, vk, common
                  ) -> CollectManyResult:
    specs = {v: spec_for(v) for v in verbs}
    fused = _engine.compose_specs(specs)
    with trace.span("facade.dims"):
        dims = _engine.Dims(dataset.num_activities, dataset.num_cases)
    est = None
    if engine == "auto":
        est = estimate(dataset) if dataset.is_files else None
        engine = choose(dataset, fused, est)
    if engine == "eager":
        if dataset.is_files:
            dataset.plan(columns=fused.columns)
        kernel = fused.make(dims, verb_kwargs=vk, **common)
        results = _fold_eager(kernel, eager_frame(dataset))
        return CollectManyResult(dict(results), None, "eager", verbs, est)
    if engine == "sharded":
        results, report = _sharded_many(dataset, specs, fused, dims,
                                        num_shards, vk, common)
        return CollectManyResult(results, report, "sharded", verbs, est)
    from repro_torch.query.exec import (execute, execute_grouped,
                                        grouped_eligible)

    with trace.span("scan"):
        kernel = fused.make(dims, verb_kwargs=vk, **common)
        with trace.span("scan.plan"):
            plan = dataset.plan(columns=fused.columns)
        if grouped_eligible(kernel, dataset.steps):
            fp = _spec_fp("+".join(verbs), dims,
                          {"verb_kwargs": sorted(vk.items()), **common})
            results, report = execute_grouped(plan, kernel, fp,
                                              device=dataset.device)
        else:
            results, report = execute(plan, kernel, prefetch=prefetch,
                                      device=dataset.device)
    _count_scan(report)
    return CollectManyResult(dict(results), report, "streaming", verbs, est)


def group_states_for(dataset, verb: str, **kwargs):
    """The per-unit material ``Dataset.window`` re-merges: ``(kernel,
    states, report)`` with one :class:`~repro_torch.core.engine.GroupState`
    per nonempty row group of the dataset's plan, resolved through the
    state cache on the dataset's device.  Raises for non-mergeable verbs
    or case-level plans (windows then fall back to scratch mining)."""
    from repro_torch.query.exec import group_states

    spec = spec_for(verb)
    dims = _engine.Dims(dataset.num_activities, dataset.num_cases)
    kernel = spec.make(dims, **kwargs)
    states, report = group_states(dataset.plan(columns=spec.columns),
                                  kernel, _spec_fp(verb, dims, kwargs),
                                  device=dataset.device)
    return kernel, states, report


def cache_probe(dataset, verb: str = "dfg", **kwargs) -> dict | None:
    """State-cache accounting for a would-be grouped collect, header-only
    (see ``repro_torch.query.exec.grouped_cache_probe``); None when the
    verb or plan is not grouped-eligible or the dataset is in-memory."""
    from repro_torch.query.exec import grouped_cache_probe

    if not dataset.is_files:
        return None
    spec = spec_for(verb)
    dims = _engine.Dims(dataset.num_activities, dataset.num_cases)
    kernel = spec.make(dims, **kwargs)
    return grouped_cache_probe(dataset.plan(columns=spec.columns), kernel,
                               _spec_fp(verb, dims, kwargs),
                               device=dataset.device)


def to_frame(dataset) -> EventFrame:
    """Materialize the filtered, projected events on the dataset's device
    (engine-agnostic: files stream through ``execute_frame``, frames
    compact in place)."""
    if dataset.is_files:
        from repro_torch.query.exec import execute_frame

        frame, _tables, _report = execute_frame(dataset.plan(),
                                                device=dataset.device)
        return frame
    return eager_frame(dataset).compact()
