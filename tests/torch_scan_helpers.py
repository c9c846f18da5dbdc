"""Test utilities of the PyTorch port's scan reports."""
from __future__ import annotations

from repro_torch.query.exec import prefetch_depth


def scan_reports_equal(got, want, prefetch=None):
    """A port ``ScanReport`` (or its JSON dict) against the JAX package's:
    every field equal, ``per_file`` too, but ``prefetch``, the read-ahead
    window.  The port's default window is its decode pool's size where the
    JAX package's is 1, so the port's is held to its own
    ``prefetch_depth(prefetch)`` wherever JAX's scan read ahead, and to 0
    where it did not.  ``None`` (an eager answer) on both sides passes."""
    if want is None:
        assert got is None
        return
    depth = prefetch_depth(prefetch)

    def check(g, w):
        assert g["prefetch"] == (depth if w["prefetch"] else 0), \
            (g["prefetch"], w["prefetch"], depth)
        assert len(g["per_file"]) == len(w["per_file"])
        for a, b in zip(g["per_file"], w["per_file"]):
            check(a, b)
        rest = [{k: v for k, v in d.items() if k not in ("prefetch", "per_file")}
                for d in (g, w)]
        assert rest[0] == rest[1]

    check(got if isinstance(got, dict) else got.to_dict(),
          want if isinstance(want, dict) else want.to_dict())
