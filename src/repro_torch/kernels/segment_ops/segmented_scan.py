"""Case-local (segmented) inclusive scans: the CUDA kernels' wrappers.

The counterparts of the JAX package's ``segmented_polyhash_pallas``,
``segmented_affine_pallas`` and ``segmented_sum_scan_pallas``
(``kernels/csrc/segmented_scan.cu``).  An unflagged row 0 continues
``carry``, the previous chunk's open segment.  Results are bitwise the
sequential fold: uint32 wraps mod 2^32, and float32 sums add in row order.

* ``segmented_polyhash_cuda`` — ``h <- h*base + v`` (mod 2^32), the
  rolling variant hash;
* ``segmented_affine_cuda``   — ``h <- h*mul + add`` with per-row maps (the
  composed sketch maps of a ghost chunk);
* ``segmented_sum_scan_cuda`` — prefix sums of (N, K) float32 or int32 rows
  (the eventually-follows prefix counts).

The polyhash and affine scans are one kernel: a single-pass block scan of
the rows' affine maps over tiles of ``TILE_ROWS`` rows, the carry
crossing tiles by a decoupled look-back over per-tile status words in
scratch this wrapper allocates (``scratch_shape``).  The sum scan stages
tiles of rows (``sum_tile_rows``) and a halo in shared memory; each run is
folded left to right (row order) there by the tile that holds its head,
one thread a (run, column), and a run that outlasts the halo is continued
window by window by the same block.

uint32 operands live in int32 tensors holding the bit patterns.  The carry
is a device tensor (0-d, or (K,) for the sum) read by the kernel through a
pointer, and ``carry_out`` is a copy of the last row written by the kernel
itself, left on the device: nothing is read back to the host, so a stream
of chunks never syncs.  On CPU tensors each wrapper takes its plain version
(``ref.segmented_scan_ref`` / ``ref.segmented_affine_ref``); on CUDA
tensors it launches the kernel on the current stream or raises.  Each
wrapper's ``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from ... import trace
from .. import _build
from .ref import segmented_affine_ref, segmented_scan_ref

_P = ctypes.c_void_p
_ARGTYPES = {
    "repro_segmented_affine": [_P, _P, _P, _P, ctypes.c_int64, _P, _P, _P, _P],
    "repro_segmented_polyhash": [_P, ctypes.c_int64, _P, _P, ctypes.c_int64,
                                 _P, _P, _P, _P],
    "repro_segmented_sum_scan": [_P, _P, _P, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, _P, _P, _P],
}
# rows a tile of the affine / polyhash scan (``kTileRows`` in the source,
# checked against the built library at first use)
TILE_ROWS = 4096


def scratch_shape(n: int) -> tuple[int, int]:
    """The affine / polyhash scan's scratch for ``n`` rows, int32: a
    128-byte line whose first word is the tile ticket, then one line a
    tile whose first 16 bytes are its status ``{kind, m, a, 0}`` (kind 0:
    nothing yet, 1: the tile's aggregate map, 2: its inclusive state).  The
    launcher zeroes it before the kernel."""
    return (1 + -(-n // TILE_ROWS), 32)


def sum_tile_rows(k: int) -> int:
    """Rows a tile of the sum scan owns at ``k`` columns (``sum_tile_rows``
    in the source): a staged window holds at most 8,192 words, 16 of its
    rows a halo, and rows wider than 256 columns are cut into slices of
    256 columns."""
    return min(256, 8192 // min(k, 256) - 16)


def _launcher(name: str):
    lib = _build.load("segmented_scan")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        if lib.repro_scan_tile_rows() != TILE_ROWS:
            raise RuntimeError(f"segmented_scan: the library tiles "
                               f"{lib.repro_scan_tile_rows()} rows, the "
                               f"wrapper {TILE_ROWS}")
        lib.repro_sum_tile_rows.argtypes = [ctypes.c_int64]
        for k in (1, 26, 256, 300):
            if lib.repro_sum_tile_rows(k) != sum_tile_rows(k):
                raise RuntimeError(f"segmented_scan: the library's sum tiles "
                                   f"at {k} columns are "
                                   f"{lib.repro_sum_tile_rows(k)} rows, the "
                                   f"wrapper's {sum_tile_rows(k)}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(what: str, rows, seg_starts: torch.Tensor, carry: torch.Tensor,
           dtype: torch.dtype, carry_shape: tuple) -> torch.device:
    device = seg_starts.device
    for t in (*rows, carry):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: operands and carry must be tensors")
        if t.device != device:
            raise ValueError(f"{what}: inputs on different devices "
                             f"{t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    n = seg_starts.shape[0]
    if seg_starts.dim() != 1 or seg_starts.dtype != torch.bool:
        raise TypeError(f"{what}: seg_starts must be 1-D bool, got "
                        f"{seg_starts.dtype} {tuple(seg_starts.shape)}")
    if not seg_starts.is_contiguous():
        raise ValueError(f"{what}: inputs must be contiguous")
    for t in rows:
        if t.shape[0] != n:
            raise ValueError(f"{what}: {tuple(t.shape)} rows against "
                             f"{n} start flags")
    if tuple(carry.shape) != carry_shape:
        raise ValueError(f"{what}: carry of shape {tuple(carry.shape)}, "
                         f"expected {carry_shape}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    return device


def segmented_polyhash_cuda(values: torch.Tensor, seg_starts: torch.Tensor,
                            carry: torch.Tensor, base: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive rolling hash ``h <- h*base + v`` (mod 2^32) of (N,) uint32
    bit patterns (int32), restarting at flagged rows; ``carry`` is a 0-d
    int32 tensor.  Returns ``(ys, carry_out)``, int32 bit patterns."""
    device = _check("segmented_polyhash", (values,), seg_starts, carry,
                    torch.int32, ())
    if values.dim() != 1:
        raise ValueError("segmented_polyhash: values must be 1-D")
    if device.type == "cpu":
        return segmented_scan_ref(values, seg_starts, carry, "polyhash", base)
    n = values.shape[0]
    if n == 0:
        return values, carry
    ys = torch.empty_like(values)
    out = torch.empty((), dtype=torch.int32, device=device)
    scratch = torch.empty(scratch_shape(n), dtype=torch.int32, device=device)
    lib, fn = _launcher("repro_segmented_polyhash")
    with trace.span("kernel.segmented_polyhash"), torch.cuda.device(device):
        err = fn(values.data_ptr(), int(base) & 0xFFFFFFFF, seg_starts.data_ptr(),
                 carry.data_ptr(), n, ys.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), _build.stream_of(ys))
    _build.check(lib, err, "segmented_polyhash")
    segmented_polyhash_cuda.launches += 1
    return ys, out


def segmented_affine_cuda(mul: torch.Tensor, add: torch.Tensor,
                          seg_starts: torch.Tensor, carry: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of per-row affine maps ``h <- h*mul + add`` (mod
    2^32) over (N,) uint32 bit patterns (int32), ``h`` reset to 0 at flagged
    rows; ``carry`` is a 0-d int32 tensor.  Returns ``(ys, carry_out)``."""
    device = _check("segmented_affine", (mul, add), seg_starts, carry,
                    torch.int32, ())
    if mul.dim() != 1 or add.dim() != 1:
        raise ValueError("segmented_affine: mul and add must be 1-D")
    if device.type == "cpu":
        return segmented_affine_ref(mul, add, seg_starts, carry)
    n = add.shape[0]
    if n == 0:
        return add, carry
    ys = torch.empty_like(add)
    out = torch.empty((), dtype=torch.int32, device=device)
    scratch = torch.empty(scratch_shape(n), dtype=torch.int32, device=device)
    lib, fn = _launcher("repro_segmented_affine")
    with trace.span("kernel.segmented_affine"), torch.cuda.device(device):
        err = fn(mul.data_ptr(), add.data_ptr(), seg_starts.data_ptr(),
                 carry.data_ptr(), n, ys.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), _build.stream_of(ys))
    _build.check(lib, err, "segmented_affine")
    segmented_affine_cuda.launches += 1
    return ys, out


def segmented_sum_scan_cuda(values: torch.Tensor, seg_starts: torch.Tensor,
                            carry: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive segmented prefix sum of (N, K) float32 or int32 rows (or
    (N,) with a 0-d carry), seeded by ``carry`` (K,) at an unflagged row 0.
    Returns ``(ys, carry_out)``; float32 sums are added in row order.
    ``carry_out`` (the last row) is written by the kernel."""
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"segmented_sum_scan: values must be float32 or "
                        f"int32, got {values.dtype}")
    if values.dim() not in (1, 2):
        raise ValueError("segmented_sum_scan: values must be (N,) or (N, K)")
    k = 1 if values.dim() == 1 else values.shape[1]
    carry_shape = () if values.dim() == 1 else (k,)
    device = _check("segmented_sum_scan", (values,), seg_starts, carry,
                    values.dtype, carry_shape)
    if device.type == "cpu":
        return segmented_scan_ref(values, seg_starts, carry, "sum")
    n = values.shape[0]
    if n == 0:
        return values, carry
    if -(-n // sum_tile_rows(k)) > 2**31 - 1:
        raise ValueError(f"segmented_sum_scan: {n} rows of {k} columns exceed "
                         f"one launch's grid")
    ys = torch.empty_like(values)
    out = torch.empty_like(carry)
    lib, fn = _launcher("repro_segmented_sum_scan")
    with trace.span("kernel.segmented_sum_scan"), torch.cuda.device(device):
        err = fn(values.data_ptr(), seg_starts.data_ptr(), carry.data_ptr(), n,
                 k, int(values.dtype == torch.float32), ys.data_ptr(),
                 out.data_ptr(), _build.stream_of(ys))
    _build.check(lib, err, "segmented_sum_scan")
    segmented_sum_scan_cuda.launches += 1
    return ys, out


segmented_polyhash_cuda.launches = 0
segmented_affine_cuda.launches = 0
segmented_sum_scan_cuda.launches = 0
