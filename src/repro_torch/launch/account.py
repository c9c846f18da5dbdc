"""Multiplicity-aware accounting of one traced step, per device.

The port's twin of the JAX package's ``launch/hlo.py``.  Eager PyTorch has
no HLO to parse, so this module counts what a step dispatches while it runs
on tensors with no storage (``meta``; DTensors of ``meta`` shards on the
dry run's mesh), and it is named after what it does.  ``Account`` is a
dispatch mode that sees every operation on the local shards (a DTensor
operation is let through to DTensor, whose local operations come back to
the mode, so the counts are one device's), and adds up:

* **dot FLOPs** -- the matrix-product family (``torch.utils.flop_counter``'s
  formulas: ``2 * numel(out) * K`` for ``mm`` / ``bmm`` / ``addmm``), and the
  flash-attention kernels' custom ops by their registered formula, the
  products the card runs (no S x S score tensor, the causal and window
  pairs only);
* **HBM bytes** -- operand plus result bytes of every operation that moves
  data (views and allocations move none): eager PyTorch fuses nothing, so
  each operation reads its inputs and writes its outputs through HBM;
* **peak live bytes** -- the storages the step allocates (each rounded up
  to the caching allocator's 512 bytes), live from their creation to their
  release, the twin of ``memory_analysis``'s temporaries; the arguments are
  counted apart by the caller.  A storage that only a reference cycle
  still holds is dead: the cyclic collector runs before any allocation
  that would raise the peak (over the objects made since the outermost
  entry, the older ones frozen), so the peak does not follow when the
  collector happens to run;
* **collective bytes by mesh axis** -- the result bytes of each functional
  collective DTensor issues (all-gather, all-reduce, reduce-scatter,
  all-to-all), by the mesh axis of its group; a group of one moves nothing.

Operations DTensor runs only to derive global shapes (its sharding
propagator) are not counted.  Where DTensor has no sharding for an
operation (a reshape that splits a sharded dim unevenly, a data-dependent
index), the operation's inputs are replicated over one mesh axis at a time
until it runs, as GSPMD reshards: the collectives that costs are counted,
and ``replicated`` names the operations.  Where DTensor's rule would move
far more than the work needs, the accounting does what a sharded program
does: one position along a split dim (a decode step's cache write) is
served by the shard that holds it, and a lookup into a table whose rows
are split (the embedding) is vocabulary-parallel, forward and backward.

A repeated unit is traced once and weighted by its count, as ``hlo.py``
weights ``while`` bodies by their trip count: ``weigh_loops`` counts each
``models.repeat.scan`` body (the SSD chunks, the mLSTM chunks, the sLSTM
tokens) ``n`` times, forward and backward (hooks on the body's autograd
nodes set the weight while they run), and the dry run
weights layers and microbatches (``launch.dryrun``).  Outputs of a data-
dependent size (the MoE dispatch's boolean index) are counted at their
bound, every row kept, and ``upper_bound`` names them.
"""
from __future__ import annotations

import contextlib
import gc
import math
import threading
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

ALLOC_ROUND = 512      # the CUDA caching allocator's block granularity
COLLECTIVES = {"all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
               "all_to_all_single", "shard_dim_alltoall", "all_gather_into_tensor_out",
               "all_reduce_", "reduce_scatter_tensor_out"}
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
            "lift_fresh"}
_NEW_FACTORIES = {torch.ops.aten.new_zeros.default, torch.ops.aten.new_empty.default,
                  torch.ops.aten.new_ones.default, torch.ops.aten.new_full.default}
_propagating = threading.local()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (an operation's
    arguments and results)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _sharding_error(e: Exception) -> bool:
    if isinstance(e, (AssertionError, IndexError)):
        # DTensor's dispatch asserting on mixed inputs; its redistribution
        # planner failing on a placement it cannot plan (torch 2.11)
        return True
    text = str(e)
    return any(k in text for k in ("Sharding propagation failed", "sharding strategy",
                                   "unevenly sharded", "redistribute", "DTensor",
                                   "data-dependent", "data dependent", "nonzero",
                                   "mixed torch.Tensor", "is invalid for input of size"))


@contextlib.contextmanager
def _skip_propagation():
    """Leave uncounted the operations DTensor's sharding propagator runs on
    global shapes to derive an output's metadata."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *args, **kwargs):
        prev = getattr(_propagating, "on", False)
        _propagating.on = True
        try:
            return orig(self, *args, **kwargs)
        finally:
            _propagating.on = prev

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _split_along(x, dim: int) -> bool:
    """Whether a mesh axis splits DTensor ``x``'s dim ``dim``."""
    return (hasattr(x, "placements") and x.ndim > 0
            and any(p.is_shard() and p.dim == dim % x.ndim for p in x.placements))


def _whole_along(x, axis: int):
    """``x`` with no mesh axis splitting its dim ``axis``."""
    if not hasattr(x, "placements") or not any(
            p.is_shard() and p.dim == axis % x.ndim for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard() and p.dim == axis % x.ndim
                                          else p for p in x.placements])


class _Repeat(torch.autograd.Function):
    """``t`` stacked ``n`` times along ``axis`` (dense, as a stack writes
    it); the gradient of the first copy flows back."""

    @staticmethod
    def forward(ctx, t, n, axis):
        ctx.axis = axis
        shape = list(t.unsqueeze(axis).shape)
        shape[axis] = n
        return t.unsqueeze(axis).expand(shape).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad.select(ctx.axis, 0), None, None


def _one_mesh(tree):
    """DTensors of one operation on one mesh: a whole (replicated) DTensor
    that DTensor's redistribution left with fewer placements than the mesh
    has axes (torch 2.11, after an uneven split) is put back on the
    operation's largest mesh, replicated over every axis."""
    from torch.distributed.tensor import DTensor, Replicate

    dts = [t for t in _tensors(tree) if isinstance(t, DTensor)]
    if not dts:
        return tree
    mesh = max((t.device_mesh for t in dts), key=lambda m: m.ndim)

    def fix(t):
        if (isinstance(t, DTensor) and (len(t.placements) != mesh.ndim
                                        or t.device_mesh.ndim != mesh.ndim)
                and tuple(t.to_local().shape) == tuple(t.shape)):
            return DTensor.from_local(t.to_local(), mesh, [Replicate()] * mesh.ndim,
                                      run_check=False, shape=t.shape, stride=t.stride())
        return t
    if all(len(t.placements) == mesh.ndim and t.device_mesh.ndim == mesh.ndim for t in dts):
        return tree
    return tree_map(fix, tree)


def _local_shape(t) -> tuple:
    """The shard shape a DTensor's placements give one device (even splits)."""
    shape = list(t.shape)
    for i, p in enumerate(t.placements):
        if p.is_shard():
            shape[p.dim] = -(-shape[p.dim] // t.device_mesh.size(i))
    return tuple(shape)


class _Emulated(torch.autograd.Function):
    """A DTensor replicated over some mesh dims by hand (a fresh ``meta``
    shard of the gathered shape; the all-gathers / all-reduces counted), and
    back in the backward pass (the gradient placed as the input was, its
    reduce-scatters counted)."""

    @staticmethod
    def forward(ctx, a, dims, acct):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = a.device_mesh
        ctx.acct, ctx.placements, ctx.local = acct, a.placements, tuple(a.to_local().shape)
        ctx.shape, ctx.stride, ctx.dims = a.shape, a.stride(), dims
        local, pl = list(ctx.local), list(a.placements)
        for d in dims:
            p = pl[d]
            if not p.is_replicate() and mesh.size(d) > 1:
                if p.is_shard():
                    local[p.dim] *= mesh.size(d)
                op = "all_gather_into_tensor" if p.is_shard() else "all_reduce"
                acct._count_coll(mesh, d, op, math.prod(local) * a.element_size())
            pl[d] = Replicate()
        out = torch.empty(local, dtype=a.dtype, device=a.to_local().device)
        acct._alloc(out)
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=a.shape,
                                  stride=a.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh = g.device_mesh
        for d in ctx.dims:
            p = ctx.placements[d]
            if p.is_shard() and mesh.size(d) > 1:
                ctx.acct._count_coll(mesh, d, "reduce_scatter_tensor",
                                     math.prod(ctx.local) * g.element_size())
        out = torch.empty(ctx.local, dtype=g.dtype, device=g.to_local().device)
        ctx.acct._alloc(out)
        return DTensor.from_local(out, mesh, ctx.placements, run_check=False,
                                  shape=ctx.shape, stride=ctx.stride), None, None


def _nodes_since(seq: int, tensors) -> list:
    """The autograd nodes reachable from ``tensors``' ``grad_fn``s that were
    created after sequence number ``seq`` (a weighted body's own nodes)."""
    out, seen = [], set()
    todo = [t.grad_fn for t in tensors if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if type(node).__name__ == "AccumulateGrad" or node._sequence_nr() <= seq:
            continue
        out.append(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return out


class Account(TorchDispatchMode):
    """Counts the operations dispatched inside it (see the module note).

    ``groups`` maps a process group's name to (mesh axis, group size), so a
    collective's bytes land on its axis; ``weight`` multiplies every count
    (a weighted unit sets it)."""

    def __init__(self, groups: dict | None = None):
        super().__init__()
        self.groups = groups or {}
        self.weight = 1.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_by_axis: dict[str, float] = {}
        self.coll_by_op: dict[str, float] = {}
        self.coll_counts: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.replicated: Counter = Counter()
        self.upper_bound: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}
        self._dt = False
        self._depth = 0
        self._stack = None

    # ------------------------------------------------------------ results
    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_by_axis.values())

    def summary(self) -> dict:
        return {"dot_flops": self.dot_flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "coll_by_axis": dict(self.coll_by_axis), "coll_by_op": dict(self.coll_by_op),
                "coll_counts": dict(self.coll_counts), "peak_bytes": self.peak,
                "flops_by_op": dict(self.flops_by_op), "replicated": dict(self.replicated),
                "upper_bound": dict(self.upper_bound)}

    # ------------------------------------------------------------- memory
    def _alloc(self, out, inputs=()) -> None:
        """Count the storages of ``out`` that no input shares (a view or an
        in-place result is no allocation; nor is an argument of the step,
        which the caller counts)."""
        shared = set()
        for t in _tensors(inputs):
            try:
                shared.add(id(t.untyped_storage()))
            except (RuntimeError, NotImplementedError):
                pass
        new = {}
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self._seen or key in shared or key in new:
                continue
            new[key] = (st, -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND)
        if self.live + sum(n for _, n in new.values()) > self.peak:
            gc.collect()            # frees what only reference cycles hold
        for key, (st, n) in new.items():
            self._seen[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        if self._depth == 0:
            self._stack = contextlib.ExitStack()
            self._stack.enter_context(_skip_propagation())
            gc.freeze()             # the collections in _alloc skip them
            self._stack.callback(gc.unfreeze)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            if self._dt:
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        if getattr(_propagating, "on", False):
            return func(*args, **kwargs)
        return self._local_op(func, args, kwargs)

    def _snapshot(self):
        return (self.dot_flops, self.hbm_bytes, dict(self.coll_by_axis),
                dict(self.coll_by_op), Counter(self.coll_counts), Counter(self.flops_by_op))

    def _restore(self, snap) -> None:
        (self.dot_flops, self.hbm_bytes, self.coll_by_axis, self.coll_by_op,
         self.coll_counts, self.flops_by_op) = snap

    def _run_dt(self, func, args, kwargs):
        self._dt = True
        try:
            with self:
                return func(*args, **kwargs)
        finally:
            self._dt = False

    def _dtensor_op(self, func, args, kwargs):
        if func in _NEW_FACTORIES:
            return self._new_factory(func, args, kwargs)
        args, kwargs = _one_mesh((args, kwargs))
        if func is torch.ops.aten.select.int and _split_along(args[0], args[1]):
            return self._select_owned(*args)
        if func is torch.ops.aten.index.Tensor:
            out = self._vocab_parallel(*args)
            if out is not None:
                return out
        if func is torch.ops.aten.index_put.default and len(args) == 4 and args[3]:
            out = self._vocab_parallel_grad(*args)
            if out is not None:
                return out
        snap = self._snapshot()
        try:
            return self._run_dt(func, args, kwargs)
        except Exception as first:   # noqa: BLE001 -- only sharding failures are retried
            if not _sharding_error(first):
                raise
            self._restore(snap)
            mesh = next(a.device_mesh for a in _tensors((args, kwargs))
                        if hasattr(a, "device_mesh"))
            for dims in [[d] for d in reversed(range(mesh.ndim))] + [list(range(mesh.ndim))]:
                snap = self._snapshot()
                try:
                    new_args, new_kwargs = self._replicate((args, kwargs), dims)
                    out = self._run_dt(func, new_args, new_kwargs)
                except Exception as e:   # noqa: BLE001
                    if not _sharding_error(e):
                        raise
                    self._restore(snap)
                    continue
                self.replicated[str(func)] += 1
                return self._inplace_result(func, args, out)
            out = self._local_fallback(func, args, kwargs, mesh)
            self.replicated[str(func)] += 1
            return self._inplace_result(func, args, out)

    def _new_factory(self, func, args, kwargs):
        """``x.new_zeros(size)`` and its kin on a DTensor: the buffer keeps
        ``x``'s sharding on the dims whose size it shares (as GSPMD places a
        fresh buffer after its producer), where DTensor would replicate it
        (autograd's backward of a gather makes one the logits' size)."""
        from torch.distributed.tensor import DTensor, Replicate

        x, size = args[0], tuple(args[1])
        mesh = x.device_mesh
        pl, local = [], list(size)
        for i, p in enumerate(x.placements):
            d = p.dim if p.is_shard() else None
            if (d is not None and d < len(size) and size[d] == x.shape[d]
                    and size[d] % mesh.size(i) == 0):
                pl.append(p)
                local[d] //= mesh.size(i)
            else:
                pl.append(Replicate())
        out = self._local_op(func, (x.to_local(), local, *args[2:]), kwargs)
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=torch.Size(size),
                                  stride=out.new_empty(size, device="meta").stride())

    def _vocab_parallel(self, table, indices):
        """``table[idx]`` with the table's rows split over some mesh axes (an
        embedding with the vocabulary split): each shard looks up the ids
        it holds and the rows are reduce-scattered over those axes onto the
        features (the vocabulary-parallel embedding), where DTensor would
        gather the whole table.  None where the placements do not fit."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        if (not isinstance(table, DTensor) or len(indices) != 1
                or not isinstance(indices[0], torch.Tensor)
                or indices[0].is_floating_point() or indices[0].dtype == torch.bool
                or not any(p.is_shard() and p.dim == 0 for p in table.placements)):
            return None
        idx = indices[0]
        mesh = table.device_mesh
        idx_pl = (idx.placements if isinstance(idx, DTensor)
                  else [Replicate()] * mesh.ndim)
        if len(idx_pl) != mesh.ndim:
            return None
        pl = []
        for tp, ip in zip(table.placements, idx_pl):
            if type(tp) is Shard and not ip.is_replicate():
                return None
            if type(tp) is Shard:
                pl.append(Partial() if tp.dim == 0 else Shard(idx.ndim + tp.dim - 1))
            elif tp.is_replicate() and (ip.is_replicate() or type(ip) is Shard):
                pl.append(ip)
            else:
                return None
        local_idx = idx.to_local() if isinstance(idx, DTensor) else idx
        out = self._local_op(torch.ops.aten.index.Tensor, (table.to_local(), [local_idx]), {})
        last = out.dim() - 1
        for i, p in enumerate(pl):
            if p.is_partial():
                # reduce-scattered over the features, as DTensor leaves an
                # embedding's rows for the products that follow
                part = out.shape[last] // mesh.size(i)
                self._count_coll(mesh, i, "reduce_scatter_tensor", _nbytes(out) // mesh.size(i))
                out = out.narrow(last, 0, part)
                pl[i] = Shard(last)
        shape = torch.Size(tuple(idx.shape) + tuple(table.shape[1:]))
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    def _vocab_parallel_grad(self, table, indices, values, accumulate):
        """The backward of a lookup: ``index_put(zeros, [idx], g,
        accumulate=True)``, shard by shard, where DTensor would gather ``g``
        (the activations' size).  Per mesh axis: rows of the table split ->
        each shard adds the rows of the ids it holds; ids (and ``g``) split
        -> partial sums of the whole table; ``g``'s features split -> the
        table's columns split.  None where the placements do not fit."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        if (not isinstance(table, DTensor) or not isinstance(values, DTensor)
                or len(indices) != 1 or not isinstance(indices[0], torch.Tensor)
                or indices[0].is_floating_point() or indices[0].dtype == torch.bool):
            return None
        idx = indices[0]
        mesh, n = table.device_mesh, idx.ndim
        if not isinstance(idx, DTensor):
            idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim, run_check=False)
        pl, idx_pl = [], []
        for tp, ip, vp in zip(table.placements, idx.placements, values.placements):
            if type(tp) is Shard and tp.dim == 0 and ip.is_replicate() and vp.is_replicate():
                pl.append(tp)
                idx_pl.append(ip)
            elif tp.is_replicate() and type(vp) is Shard and vp.dim < n \
                    and (ip.is_replicate() or ip == vp):
                pl.append(Partial())
                idx_pl.append(vp)            # the ids split as ``g``'s rows are
            elif tp.is_replicate() and type(vp) is Shard and vp.dim >= n \
                    and ip.is_replicate():
                pl.append(Shard(vp.dim - n + 1))
                idx_pl.append(ip)
            elif tp.is_replicate() and ip.is_replicate() and vp.is_replicate():
                pl.append(Replicate())
                idx_pl.append(ip)
            else:
                return None
        if list(idx_pl) != list(idx.placements):
            idx = idx.redistribute(mesh, idx_pl)     # a local slice: moves nothing
        local = table.to_local()
        for tp, p, i in zip(table.placements, pl, range(mesh.ndim)):
            if type(p) is Shard and tp.is_replicate():
                local = local.narrow(p.dim, 0, local.shape[p.dim] // mesh.size(i))
        out = self._local_op(torch.ops.aten.index_put.default,
                             (local, [idx.to_local()], values.to_local(), accumulate), {})
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=table.shape,
                                  stride=table.stride())

    def _select_owned(self, x, dim: int, index: int):
        """One position of a dim the mesh splits, served by the shard that
        holds it (a decode step's write into the sequence-split cache): a
        view of the local shard, whole over the axes that split ``dim``,
        where DTensor would gather the whole tensor first.  Nothing is
        moved: a write lands in place, in the shard."""
        from torch.distributed.tensor import DTensor, Replicate

        dim = dim % x.ndim
        mesh, local = x.device_mesh, x.to_local()
        out = local.select(dim, index % local.shape[dim])
        pl = [p for p in x.placements]
        for i, p in enumerate(pl):
            if p.is_shard() and p.dim == dim:
                pl[i] = Replicate()
            elif p.is_shard() and p.dim > dim:
                pl[i] = type(p)(p.dim - 1) if type(p).__name__ == "Shard" else p
        shape = x.shape[:dim] + x.shape[dim + 1:]
        stride = x.stride()[:dim] + x.stride()[dim + 1:]
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    @staticmethod
    def _inplace_result(func, args, out):
        """An in-place operation returns its own first argument."""
        rets = func._schema.returns
        if rets and rets[0].alias_info is not None and rets[0].alias_info.is_write:
            return args[0]
        return out

    def _replicate(self, tree, dims):
        from torch.distributed.tensor import DTensor, Replicate

        def rep(a):
            if not isinstance(a, DTensor) or not a.numel():
                return a
            pl = list(a.placements)
            if all(pl[d].is_replicate() for d in dims):
                return a
            for d in dims:
                pl[d] = Replicate()
            self._dt = True
            try:
                with self:
                    out = a.redistribute(a.device_mesh, pl)
            except IndexError:
                return self._gathered(a, dims)
            finally:
                self._dt = False
            if tuple(out.to_local().shape) != _local_shape(out):
                return self._gathered(a, dims)     # a planner that lost a shard
            return out
        return tree_map(rep, tree)

    def _gathered(self, a, dims):
        """``a`` replicated over mesh dims ``dims`` without DTensor's planner
        (which fails on some placements in torch 2.11): each split dim
        gathered (an all-gather of the result's bytes), each partial sum
        all-reduced; differentiable (the backward reduce-scatters)."""
        return _Emulated.apply(a, tuple(dims), self)

    def _count_coll(self, mesh, d: int, op: str, nbytes: float) -> None:
        b = self.weight * nbytes
        axis = mesh.mesh_dim_names[d] if mesh.mesh_dim_names else str(d)
        self.coll_by_axis[axis] = self.coll_by_axis.get(axis, 0.0) + b
        self.coll_by_op[op] = self.coll_by_op.get(op, 0.0) + b
        self.coll_counts[op] += 1

    def _local_fallback(self, func, args, kwargs, mesh):
        """Run an operation DTensor cannot shard on whole (replicated)
        tensors, its result replicated."""
        from torch.distributed.tensor import DTensor, Replicate

        every = tuple(range(mesh.ndim))
        full_args, full_kwargs = tree_map(
            lambda a: self._gathered(a, every) if isinstance(a, DTensor) else a, (args, kwargs))
        full_args, full_kwargs = tree_map(
            lambda a: a.to_local() if isinstance(a, DTensor) else a, (full_args, full_kwargs))
        out = self._local_op(func, full_args, full_kwargs)
        return tree_map(lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)

    # ------------------------------------------------------ local counts
    def _local_op(self, func, args, kwargs):
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        args, kwargs = self._bound_data_dependent(func, args, kwargs)
        if func is torch.ops.aten.nonzero.default:
            mask = args[0]
            self.upper_bound[str(func)] += 1
            out = torch.empty((mask.numel(), mask.dim()), dtype=torch.long, device=mask.device)
        else:
            try:
                out = func(*args, **kwargs)
            except RuntimeError as e:
                # a view of a shard whose strides are not the global tensor's
                # (DTensor relays its local results densely): a copy first
                if func is not torch.ops.aten.view.default or "view size" not in str(e):
                    raise
                dense = args[0].contiguous()
                self.hbm_bytes += self.weight * 2 * _nbytes(dense)
                self._alloc(dense)
                args = (dense, *args[1:])
                out = func(*args, **kwargs)
        w = self.weight
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional") and name in COLLECTIVES:
            self._collective(func, name, args, out, w)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            self.dot_flops += w * flops
            self.flops_by_op[str(func._overloadpacket)] += w * flops
        if not (_is_view(func) or name in _NO_DATA or ns == "prim"):
            b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            b += sum(_nbytes(t) for t in _tensors(out))
            self.hbm_bytes += w * b
        self._alloc(out, (args, kwargs))
        return out

    def _collective(self, func, name, args, out, w) -> None:
        group = next((a for a in args if isinstance(a, str) and a in self.groups), None)
        axis, size = self.groups.get(group, ("?", 0))
        if size == 1:
            return
        b = w * sum(_nbytes(t) for t in _tensors(out))
        base = name.rstrip("_").replace("_out", "")
        self.coll_by_axis[axis] = self.coll_by_axis.get(axis, 0.0) + b
        self.coll_by_op[base] = self.coll_by_op.get(base, 0.0) + b
        self.coll_counts[base] += 1

    def _bound_data_dependent(self, func, args, kwargs):
        """A boolean index has a data-dependent size: count it at its bound,
        every position kept (integer indices of all positions)."""
        if func not in (torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default,
                        torch.ops.aten.index_put.default):
            return args, kwargs
        idx = args[1]
        if not any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in idx):
            return args, kwargs
        new = []
        for i in idx:
            if isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8):
                n = i.numel()
                new += [torch.empty((n,), dtype=torch.long, device=i.device)
                        for _ in range(i.dim())]
            else:
                new.append(i)
        self.upper_bound[str(func)] += 1
        return (args[0], new, *args[2:]), kwargs

    # ------------------------------------------------------- weighted units
    @contextlib.contextmanager
    def weighted(self, weight: float):
        """Counts inside run at ``weight`` times the current weight."""
        prev = self.weight
        self.weight = prev * weight
        try:
            yield
        finally:
            self.weight = prev

    def _weigh(self, n: int, body, carry, xs, axis):
        """``repeat.scan`` with its body traced once and counted ``n`` times.
        Each autograd node the body created runs its backward at the body's
        weight (a pre-hook sets it, a hook restores it).  A DTensor of
        ``xs`` split along the step axis is first gathered whole along it
        (once, as GSPMD would before a loop that slices it; DTensor would
        gather it at every step).  The outputs are the one step's stacked
        ``n`` times, which writes what the loop's stack writes; the
        gradient reaches the step through the first copy.  The other steps'
        saved tensors are not held (under ``remat_policy`` ``"full"`` a
        body saves nothing in the forward pass; the recompute of one unit
        in the backward pass is undercounted by them)."""
        w0 = self.weight
        xs = tuple(_whole_along(x, axis) for x in xs)
        grad = torch.is_grad_enabled()
        if grad:
            # a step after the first differentiates its carry: the traced one
            # does too (the first step's carry-gradient work is counted once
            # too often)
            carry = tree_map(lambda t: t.detach().requires_grad_()
                             if isinstance(t, torch.Tensor) and t.is_floating_point()
                             and not t.requires_grad else t, carry)
            carry_in = _tensors(carry)
            with self.weighted(0):
                s0 = (torch.zeros((), device="meta", requires_grad=True) * 1).grad_fn
            s0 = s0._sequence_nr()
        with self.weighted(n):
            carry, y = body(carry, *(x.select(axis, 0) for x in xs))
        if grad:
            nodes = _nodes_since(s0, _tensors((carry, y)))
            body = {id(node) for node in nodes}
            carried = {(id(t.grad_fn), t.output_nr) for t in carry_in if t.grad_fn is not None}
            leaves = {id(t) for t in carry_in if t.grad_fn is None}
            for node in nodes:
                node.register_prehook(lambda *_, w=w0 * n: setattr(self, "weight", w))
                node.register_hook(lambda *_, w=w0: setattr(self, "weight", w))
                # gradients leaving the body for a tensor every step reads
                # (a weight, ``xs``): the loop's other steps send theirs too,
                # and autograd sums them, n - 1 adds the traced step lacks
                shared = [i for i, (fn, nr) in enumerate(node.next_functions)
                          if fn is not None and id(fn) not in body
                          and (id(fn), nr) not in carried
                          and id(getattr(fn, "variable", None)) not in leaves]
                if shared:
                    node.register_hook(lambda gin, _, idx=shared: self._sums(gin, idx, n - 1))
        return carry, tree_map(lambda t: _Repeat.apply(t, n, axis), y)

    def _sums(self, grads, idx, count: int) -> None:
        """``count`` gradient sums (read two, write one) of each of
        ``grads[idx]``, at the current weight."""
        for i in idx:
            g = grads[i]
            if g is not None:
                local = g.to_local() if hasattr(g, "to_local") else g
                self.hbm_bytes += self.weight * count * 3 * _nbytes(local)

    @contextlib.contextmanager
    def weigh_loops(self):
        """Within: every ``models.repeat.scan`` is traced once and weighted."""
        from repro_torch.models import repeat

        prev = repeat.WEIGHER
        repeat.WEIGHER = self._weigh
        try:
            yield
        finally:
            repeat.WEIGHER = prev


def group_axes(mesh) -> dict:
    """``{group name: (axis, size)}`` of a ``launch.mesh.Mesh``'s axes."""
    dm = mesh.device_mesh
    return {dm.get_group(name).group_name: (name, size)
            for name, size in mesh.shape.items()}


def combine(parts: list[tuple[float, dict]]) -> dict:
    """The weighted sum of ``summary()``s: ``sum(w * s)`` of every count
    (peaks too: a linear extrapolation over traces of different depths)."""
    out: dict = {}
    for w, s in parts:
        for k, v in s.items():
            if isinstance(v, dict):
                d = out.setdefault(k, {})
                for kk, vv in v.items():
                    d[kk] = d.get(kk, 0.0) + w * vv
            else:
                out[k] = out.get(k, 0.0) + w * v
    return out
