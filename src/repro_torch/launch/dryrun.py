"""Dry run of every production cell on an H100 mesh, with no card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each (arch x
shape x mesh) cell on placeholder devices and reads XLA's analyses.  Here
each cell is traced instead (``launch.account``) on storage-less tensors:

1. a fake process group (``launch.mesh.fake_world``) and the production
   mesh, (32, 8) data x model or (2, 32, 8) with ``--multi-pod``, torn down
   when the cell ends;
2. parameters, optimizer state, inputs and cache as DTensors of ``meta``
   shards, placed by their sanitized specs (``models.model.param_specs``,
   ``train.trainstep.state_specs``, ``launch.specs``);
3. the step of the cell's kind -- ``train_step`` (``grad_step`` per
   microbatch, then ``finish_step``), ``prefill`` or ``decode_step`` --
   traced under ``implicit_replication()`` and the accounting.  A ``meta``
   tensor takes the kernels' route (``core.backend.resolve``), so attention
   is counted as the flash-attention kernels run it;
4. a JSON record appended to ``--out``: the JAX package's keys (``ok``,
   ``flops_per_device``, ``bytes_per_device``,
   ``collective_bytes_per_device``, ``collectives``, ``memory``, ``params``,
   ``active_params``) plus ``params_held`` (the abstract model's count;
   ``ModelConfig.param_count`` undercounts xlstm-1.3b), the collectives by
   mesh axis, and the operations counted at a bound or replicated.

Repeated units are traced once and weighted: the SSD / mLSTM / sLSTM loops
by the accounting, microbatches by tracing the first and one later one
(``.grad`` is set, so it accumulates) and weighting the later one by
``n - 1``, and layers by tracing the model at two or three cut depths and
extrapolating linearly (``depth_plan``: exact for counts, which are linear
in the layer count; the peak is extrapolated the same way).  The argument
bytes are the full model's, exactly.  A cell that fails to trace is
``ok: false`` with its error; none is skipped.

Usage::

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod] --out results/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, Shape, cells
from repro_torch.launch import account as A
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, batch_rules, fake_world,
                                     local_shape, make_production_mesh, make_rules,
                                     mesh_name, placements, sanitize_spec)
from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import Creator, PartitionSpec
from repro_torch.train import trainstep as TS
from repro_torch.train.optimizer import OptConfig

# Per-arch microbatch counts of the train cells (global batch 256 x 4,096):
# the fewest whose dry-run peak on the (32, 8) mesh stays under 90 % of the
# card's 80 GB under torch 2.11, or 8, the most a 256-sequence batch allows
# with each microbatch split over the 32-wide data axis, where none does
# (this dry run at 1, 2, 4 and 8 microbatches; the figures are in PERF.md).
TRAIN_MICROBATCHES: dict[str, int] = {"qwen3-moe-30b-a3b": 8, "mixtral-8x7b": 8,
                                      "zamba2-7b": 8, "xlstm-1.3b": 8, "gemma3-4b": 4}
DEFAULT_MICROBATCHES = 1


# ---------------------------------------------------------------- placing
def dtensor(shape, spec, dtype, mesh):
    """A DTensor of global ``shape`` placed by the sanitized ``spec``, its
    shard a ``meta`` tensor."""
    from torch.distributed.tensor import DTensor

    spec = sanitize_spec(tuple(shape), spec, mesh)
    local = torch.empty(local_shape(tuple(shape), spec, mesh), dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh.device_mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


class ShardedCreator(Creator):
    """Parameters as DTensors of ``meta`` shards placed by their logical
    axes under ``rules``."""

    def __init__(self, mesh, rules, dtype: str):
        self.mesh, self.rules, self.dtype = mesh, rules, dtype

    def __call__(self, name, shape, axes=None, dtype=None, scale=None):
        t = dtensor(shape, self.rules.spec(axes), getattr(torch, dtype or self.dtype),
                    self.mesh)
        t.logical_axes = tuple(axes)
        return t


class _Gather(torch.nn.Module):
    """FSDP's gather at use: a parameter stored sharded over the FSDP axes
    is cast to the compute dtype and all-gathered over them each time the
    model reads it (its gradient reduce-scattered back by autograd)."""

    def __init__(self, placements, dtype):
        super().__init__()
        self.placements, self.dtype = placements, dtype

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        return x.redistribute(x.device_mesh, self.placements)


def fsdp(model, mesh, rules, compute_dtype: str) -> None:
    """Parametrize every parameter stored sharded over the FSDP axes (the
    mesh axes of ``rules.embed``) with ``_Gather``: GSPMD's all-gather of a
    weight before its product, which DTensor's per-operation choice would
    otherwise trade for a gather of the (smaller, batch-sharded)
    activations."""
    from torch.distributed.tensor import Replicate
    from torch.nn.utils import parametrize

    axes = rules.embed if isinstance(rules.embed, tuple) else (rules.embed,)
    axes = [a for a in axes if mesh.shape.get(a, 1) > 1]
    dt = getattr(torch, compute_dtype)
    for mod in list(model.modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            pl = list(p.placements)
            gathered = [Replicate() if mesh.axis_names[i] in axes and pl[i].is_shard()
                        else pl[i] for i in range(len(pl))]
            if gathered != pl:
                cast = dt if p.dim() >= 2 and p.dtype != dt else None
                parametrize.register_parametrization(mod, name, _Gather(gathered, cast),
                                                     unsafe=True)


def place(tree, specs, mesh):
    """``meta`` tensors of a tree placed as DTensors by their specs; other
    leaves (the cache's ``pos``) kept."""
    if isinstance(specs, PartitionSpec):
        return dtensor(tree.shape, specs, tree.dtype, mesh) \
            if isinstance(tree, torch.Tensor) else tree
    return {k: place(tree[k], s, mesh) for k, s in specs.items()}


def local_bytes(tree, specs, mesh) -> int:
    """One device's bytes of a tree of ``meta`` tensors under its specs."""
    if isinstance(specs, PartitionSpec):
        if not isinstance(tree, torch.Tensor):
            return 0
        spec = sanitize_spec(tuple(tree.shape), specs, mesh)
        n = 1
        for s in local_shape(tuple(tree.shape), spec, mesh):
            n *= s
        return n * tree.element_size()
    return sum(local_bytes(tree[k], s, mesh) for k, s in specs.items())


# ------------------------------------------------------------ depth plans
def depth_plan(cfg: ModelConfig) -> list[tuple[ModelConfig, float]]:
    """Cut configurations and their weights whose weighted sum of counts is
    the whole model's: every count is linear in each stack's layer count,
    so two traces that differ by one unit give the unit."""
    L = cfg.num_layers
    fam = cfg.family
    if fam == "audio":
        E = cfg.enc_layers
        return [(cfg.with_overrides(enc_layers=1, num_layers=1), 1 - (E - 1) - (L - 1)),
                (cfg.with_overrides(enc_layers=2, num_layers=1), E - 1),
                (cfg.with_overrides(enc_layers=1, num_layers=2), L - 1)]
    if fam == "hybrid":
        every = cfg.shared_attn_every
        G, tail = L // every, L % every
        return [(cfg.with_overrides(num_layers=every + tail), 2 - G),
                (cfg.with_overrides(num_layers=2 * every + tail), G - 1)]
    if fam == "ssm":
        every = cfg.slstm_every
        G = L // every
        return [(cfg.with_overrides(num_layers=every), 2 - G),
                (cfg.with_overrides(num_layers=2 * every), G - 1)]
    if cfg.global_every:
        # kinds with global_every 2: [local], [local, global], [local, global, local]
        n_global = L // cfg.global_every
        n_local = L - n_global
        cut = [cfg.with_overrides(num_layers=n, global_every=2) for n in (1, 2, 3)]
        return [(cut[0], 1 - n_global), (cut[1], n_global - n_local + 1),
                (cut[2], n_local - 1)]
    return [(cfg.with_overrides(num_layers=1), 2 - L),
            (cfg.with_overrides(num_layers=2), L - 1)]


# ---------------------------------------------------------------- tracing
def _register_strategies():
    """DTensor strategies DTensor lacks, registered once inside a dry run.
    The flash-attention custom ops: all replicated; the batch split; the heads split
    (query and KV heads alike); or the query heads split with K / V whole
    (GQA with fewer KV heads than the axis: each device reads every KV head
    and its dK / dV are partial sums).  The counts are the same products on
    a device's heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    if getattr(_register_strategies, "done", False):
        return
    ops = torch.ops.repro_torch
    R, S0, S1 = Replicate(), Shard(0), Shard(1)

    @register_sharding(ops.flash_attention.default)
    def _fwd(q, k, v, kv_len_t, kv_len_v, causal, window, p_code, return_lse):
        rest = [None] * 6
        lse = (lambda p: p) if return_lse else (lambda p: R)
        return [([R, R], [R, R, R] + rest),
                ([S0, lse(S0)], [S0, S0, S0] + rest),
                ([S1, lse(S1)], [S1, S1, S1] + rest),
                ([S1, lse(S1)], [S1, R, R] + rest)]

    @register_sharding(ops.flash_attention_bwd.default)
    def _bwd(q, k, v, o, lse, do, kv_len_t, kv_len_v, causal, window, p_code):
        rest = [None] * 5
        return [([R, R, R], [R] * 6 + rest),
                ([S0, S0, S0], [S0] * 6 + rest),
                ([S1, S1, S1], [S1] * 6 + rest),
                ([S1, Partial(), Partial()], [S1, R, R, S1, S1, S1] + rest)]

    # log_sigmoid has no DTensor strategy: elementwise, split on any dim;
    # its buffer (empty on a card) stays replicated
    @register_sharding(torch.ops.aten.log_sigmoid_forward.default)
    def _logsig(x):
        return [([R, R], [R])] + [([Shard(d), R], [Shard(d)]) for d in range(x.ndim)]

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _logsig_bwd(g, x, buffer):
        return [([R], [R, R, R])] + [([Shard(d)], [Shard(d), Shard(d), R])
                                     for d in range(x.ndim)]

    _register_strategies.done = True


def _out_bytes(out) -> int:
    seen, n = set(), 0
    for t in A._tensors(out):
        local = t.to_local() if hasattr(t, "to_local") else t
        key = id(local.untyped_storage())
        if key not in seen:
            seen.add(key)
            n += A._nbytes(local)
    return n


def trace(cfg: ModelConfig, shape: Shape, mesh, rules, num_microbatches: int = 1) -> dict:
    """Counts of one cut configuration's step on ``mesh`` (``Account``'s
    summary plus ``output_bytes``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    acct = A.Account(A.group_axes(mesh))
    model = Mdl.init_params(cfg, ShardedCreator(mesh, rules, cfg.param_dtype))
    fsdp(model, mesh, rules, cfg.compute_dtype)
    if shape.kind == "train":
        params = dict(model.named_parameters())
        opt = {key: {k: p.new_empty(p.shape, dtype=torch.float32)
                     for k, p in params.items()} for key in ("m", "v")}
        opt["step"] = dtensor((), PartitionSpec(), torch.int32, mesh)
        state = {"params": model, "opt": opt}
        mb_shape = Shape(shape.name, shape.kind, shape.seq, shape.batch // num_microbatches)
        batch, bspecs = SP.train_batch_specs(cfg, mb_shape, rules)
        mbs = [place(batch, bspecs, mesh) for _ in range(min(num_microbatches, 2))]
        with acct, implicit_replication(), acct.weigh_loops():
            for p in params.values():
                p.grad = None
            if num_microbatches == 1:
                loss = TS.grad_step(cfg, model, mbs[0])
            else:
                loss = torch.zeros((), dtype=torch.float32, device="meta")
                loss = loss + TS.grad_step(cfg, model, mbs[0])
                with acct.weighted(num_microbatches - 1):
                    loss = loss + TS.grad_step(cfg, model, mbs[1])
            out = TS.finish_step(OptConfig(), state, loss, num_microbatches)[1]
    else:
        if shape.kind == "prefill":
            inputs, ispecs = SP.prefill_specs(cfg, shape, rules)
            inputs = place(inputs, ispecs, mesh)
            with acct, implicit_replication(), acct.weigh_loops(), torch.no_grad():
                out = Mdl.prefill(cfg, model, inputs["tokens"],
                                  frontend=inputs.get("frontend"))
        else:
            inputs, ispecs = SP.decode_specs(cfg, shape, rules)
            inputs = place(inputs, ispecs, mesh)
            inputs["cache"]["pos"] = shape.seq - 1
            with acct, implicit_replication(), acct.weigh_loops(), torch.no_grad():
                out = Mdl.decode_step(cfg, model, inputs["cache"], inputs["tokens"])
    return {**acct.summary(), "output_bytes": _out_bytes(out)}


def argument_bytes(cfg: ModelConfig, shape: Shape, mesh, rules) -> dict:
    """One device's argument bytes of the whole (uncut) cell: parameters,
    optimizer state (train), inputs and cache, and the held parameter
    count."""
    model = Mdl.abstract_params(cfg)
    pspecs = Mdl.param_specs(cfg, rules, model)
    params = dict(model.named_parameters())
    out = {"params": local_bytes(params, pspecs, mesh),
           "params_held": sum(p.numel() for p in params.values())}
    if shape.kind == "train":
        f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for k, p in params.items()}
        out["opt"] = 2 * local_bytes(f32, pspecs, mesh) + 4
        batch, bspecs = SP.train_batch_specs(cfg, shape, rules)
        out["inputs"] = local_bytes(batch, bspecs, mesh)
    elif shape.kind == "prefill":
        inputs, ispecs = SP.prefill_specs(cfg, shape, rules)
        out["inputs"] = local_bytes(inputs, ispecs, mesh)
    else:
        inputs, ispecs = SP.decode_specs(cfg, shape, rules)
        out["inputs"] = local_bytes(inputs, ispecs, mesh)
    return out


def cell_config(arch: str, shape: Shape, overrides: dict | None = None) -> ModelConfig:
    """The cell's configuration: training keeps the parameters in float32
    (AdamW's master weights), serving holds them in bf16, as in the JAX
    package."""
    cfg = get_config(arch)
    if shape.kind == "train":
        cfg = cfg.with_overrides(seq_parallel=True)
    else:
        cfg = cfg.with_overrides(param_dtype="bfloat16")
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    return cfg


def account_cell(cfg: ModelConfig, shape: Shape, mesh, num_microbatches: int = 1) -> dict:
    """The whole cell's per-device counts: the depth plan's traces combined,
    and the exact argument bytes."""
    _register_strategies()
    n = num_microbatches if shape.kind == "train" else 1
    rules = make_rules(mesh, cfg, seq_parallel=cfg.seq_parallel)
    rules = batch_rules(rules, mesh, shape.batch // n)
    parts = [(w, trace(c, shape, mesh, rules, n)) for c, w in depth_plan(cfg) if w]
    tot = A.combine(parts)
    args = argument_bytes(cfg, shape, mesh, rules)
    arg_total = args["params"] + args.get("opt", 0) + args["inputs"]
    temp = max(0.0, tot["peak_bytes"] - tot["output_bytes"])
    return {"counts": tot, "arguments": args,
            "memory": {"argument_bytes": arg_total, "output_bytes": tot["output_bytes"],
                       "temp_bytes": temp, "peak_bytes": arg_total + tot["peak_bytes"]}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, out_path=None,
             overrides=None, num_microbatches: int | None = None,
             tag: str = "baseline") -> dict:
    shape = SHAPES[shape_name]
    n = num_microbatches or TRAIN_MICROBATCHES.get(arch, DEFAULT_MICROBATCHES)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_name(MULTI_POD if multi_pod else SINGLE_POD), "tag": tag}
    t0 = time.perf_counter()
    try:
        cfg = cell_config(arch, shape, overrides)
        with fake_world(512 if multi_pod else 256):
            cell = account_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod), n)
        c = cell["counts"]
        rec.update(
            ok=True, trace_s=time.perf_counter() - t0,
            flops_per_device=c["dot_flops"], bytes_per_device=c["hbm_bytes"],
            collective_bytes_per_device=c["collective_bytes"],
            collectives=c["coll_by_op"], collectives_by_axis=c["coll_by_axis"],
            collective_counts=c["coll_counts"], flops_by_op=c["flops_by_op"],
            memory=cell["memory"], arguments=cell["arguments"],
            params=cfg.param_count(), active_params=cfg.active_param_count(),
            params_held=cell["arguments"]["params_held"],
            num_microbatches=n if shape.kind == "train" else 1,
            compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
            replicated=c["replicated"], upper_bound=c["upper_bound"],
            fits=cell["memory"]["peak_bytes"] <= RL.HBM_BYTES)
        if cfg.num_experts and c["upper_bound"]:
            rec["moe_dispatch"] = "upper bound"
        print(f"[dryrun] {arch} {shape_name} {rec['mesh']} OK "
              f"trace={rec['trace_s']:.1f}s flops/dev={rec['flops_per_device']:.3e} "
              f"peak={cell['memory']['peak_bytes'] / 2**30:.2f}GiB "
              f"coll={c['collective_bytes'] / 2**20:.1f}MiB", flush=True)
    except Exception as e:  # a failing cell is a bug in the system
        rec.update(ok=False, trace_s=time.perf_counter() - t0,
                   error=f"{type(e).__name__}: {e}"[:2000],
                   trace=traceback.format_exc()[-3000:])
        print(f"[dryrun] {arch} {shape_name} {rec['mesh']} FAIL {rec['error'][:300]}\n"
              f"{rec['trace']}", flush=True)
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    overrides = json.loads(args.override) if args.override else None
    todo = ([(a, s) for a in ARCH_IDS for s in cells(a)] if args.all
            else [(args.arch, args.shape)])
    kw = dict(multi_pod=args.multi_pod, overrides=overrides,
              num_microbatches=args.microbatches, tag=args.tag)
    if args.jobs > 1 and len(todo) > 1:
        import multiprocessing as mp

        # a worker traces one cell at a time, each in its own fake process
        # group; the slowest cells (training) go first
        order = sorted(range(len(todo)), key=lambda i: SHAPES[todo[i][1]].kind != "train")
        with mp.get_context("spawn").Pool(args.jobs) as pool:
            done = pool.starmap(_cell_job, [(*todo[i], kw) for i in order], chunksize=1)
        recs = [None] * len(todo)
        for i, rec in zip(order, done):
            recs[i] = rec
        with open(args.out, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    else:
        recs = [run_cell(a, s, out_path=args.out, **kw) for a, s in todo]
    return 0 if all(r["ok"] for r in recs) else 1


def _cell_job(arch: str, shape_name: str, kw: dict) -> dict:
    return run_cell(arch, shape_name, **kw)


if __name__ == "__main__":
    raise SystemExit(main())
