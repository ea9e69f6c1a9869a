"""Wrapper of the MSM kernel (`msm.cu`) and its plain version.

`repro_torch.core.group`'s MSMs (`msm_many`, `msm`, `msm_field`,
`msm_segments`, `msm_ragged`) call these on the card.  CPU tensors take
the plain version, the sort-based Pippenger of `group.msm_many_plain` /
`group.msm_ragged_plain`; CUDA tensors launch the kernel, or raise --
there is no fallback.

A call is R rows of up to three segments laid end to end.  A segment is
``(points, exps)``: ``exps`` an (R, n) int64 tensor or a list of R (n,)
tensors, ``points`` the same, or one (n,) vector that every row shares.
A list's rows must lie evenly spaced in memory (halves of one vector
do, in either order), so that ``[v[n:], v[:n]]`` is read in place.
Every row must be contiguous along its terms.  Points are FP group
elements in Montgomery form, exponents standard-form words below
2^nbits (the kernel reads their low ``nbits`` bits only).

The launch geometry follows the shape, with no option: a thread takes K
terms (K grows from 1 to 16 with the total number of terms, so that
about 2^18 threads are in flight before the squarings are shared wider),
a block takes up to 256 threads of one row, so short rows get a warp,
and a row longer than one block's tile is finished by a second launch
that multiplies its partials.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.field import FP
from repro_torch.kernels import _build

MAX_SEGMENTS = 3
MAX_TERMS_PER_THREAD = 16
MAX_THREADS = 256
#: threads in flight before a thread takes more than one term
_THREADS_IN_FLIGHT = 1 << 18


def geometry(n_terms: int, n_rows: int):
    """(K, threads): terms a thread takes and threads a block, for n_rows
    rows of n_terms terms in all."""
    k = 1
    while k < MAX_TERMS_PER_THREAD and n_terms >= 2 * k * _THREADS_IN_FLIGHT:
        k *= 2
    per_row = -(-n_terms // max(1, n_rows))
    threads = 32
    while threads < MAX_THREADS and threads * k < per_row:
        threads *= 2
    return k, threads


def _words(t: torch.Tensor, n: int, what: str) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 words, got {t.dtype}")
    if t.shape[-1] != n:
        raise ValueError(f"{what}: {t.shape[-1]} terms, expected {n}")
    if n > 1 and t.stride(-1) != 1:
        raise ValueError(f"{what}: every row must be contiguous along its "
                         "terms")


class _Rows:
    """R rows of n words: a list of R 1-D tensors, an (R, n) tensor or,
    for points, one (n,) tensor shared by every row."""

    def __init__(self, x, rows, what: str, shared_ok: bool):
        self.x = x
        if isinstance(x, (list, tuple)):
            self.kind, self.rows = "list", len(x)
            if rows is not None and self.rows != rows:
                raise ValueError(f"{what}: {self.rows} rows, expected {rows}")
            if any(not isinstance(t, torch.Tensor) or t.dim() != 1
                   for t in x):
                raise ValueError(f"{what}: a list must hold 1-D tensors")
            self.n = x[0].shape[0] if x else 0
            for t in x:
                _words(t, self.n, what)
            self.devices = {t.device for t in x}
            self.ptr_stride()           # the same layout on every device
        elif isinstance(x, torch.Tensor) and x.dim() == 1 and shared_ok:
            self.kind, self.rows, self.n = "shared", rows, x.shape[0]
            _words(x, self.n, what)
            self.devices = {x.device}
        elif isinstance(x, torch.Tensor) and x.dim() == 2 and \
                rows in (None, x.shape[0]):
            self.kind, (self.rows, self.n) = "dense", x.shape
            _words(x, self.n, what)
            self.devices = {x.device}
        else:
            raise ValueError(f"{what}: expected {rows or 'R'} rows, got "
                             f"{getattr(x, 'shape', type(x))}")

    def dense(self) -> torch.Tensor:
        """(R, n), or (n,) when shared (a list is copied)."""
        return torch.stack(list(self.x)) if self.kind == "list" else self.x

    def ptr_stride(self):
        """The first row's address and the words between rows."""
        if self.kind == "list":
            ptrs = [t.data_ptr() for t in self.x]
            step = ptrs[1] - ptrs[0] if len(ptrs) > 1 else 0
            if step % 8 or any(b - a != step
                               for a, b in zip(ptrs, ptrs[1:])):
                raise ValueError("msm: the rows of a list must lie evenly "
                                 "spaced in memory")
            return ptrs[0], step // 8
        stride = self.x.stride(0) if self.kind == "dense" else 0
        return self.x.data_ptr(), stride if self.rows > 1 else 0


def _segments(segments) -> list:
    """[(points _Rows, exps _Rows)], checked against each other."""
    segs = list(segments)
    if not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(f"msm: 1 to {MAX_SEGMENTS} segments, got "
                         f"{len(segs)}")
    out, rows = [], None
    for points, exps in segs:
        e = _Rows(exps, rows, "msm exps", False)
        rows = e.rows
        p = _Rows(points, rows, "msm points", True)
        if p.n != e.n:
            raise ValueError(f"msm: {p.n} points against {e.n} exponents")
        out.append((p, e))
    if len(set().union(*(p.devices | e.devices for p, e in out))) > 1:
        raise ValueError("msm: tensors on different devices")
    return out


def _check_device(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {dev}")


def _emask(nbits: int) -> int:
    if not 1 <= nbits <= 64:
        raise ValueError(f"msm: nbits {nbits} outside [1, 64]")
    return (1 << nbits) - 1


def msm_plain(segments, nbits: int = 61) -> torch.Tensor:
    """The segments concatenated row by row, through `group.msm_many_plain`
    (on any device: the oracle the kernel is held against)."""
    from repro_torch.core import group
    segs = _segments(segments)
    rows = segs[0][1].rows
    exps = torch.cat([e.dense() for _, e in segs], dim=1)
    if all(p.kind == "shared" for p, _ in segs):
        pts = torch.cat([p.dense() for p, _ in segs])
    else:
        pts = torch.cat([p.dense().expand(rows, -1) for p, _ in segs], dim=1)
    return group.msm_many_plain(pts, exps, nbits)


def _launch(seg_desc, term_off, tile_off, rows, tiles, tiles_per_row,
            threads, k, nbits, partial, out) -> None:
    flat = [v for d in seg_desc for v in d]
    err = _build.lib("msm").zk_msm(
        (ctypes.c_int64 * len(flat))(*flat), len(seg_desc),
        None if term_off is None else term_off.data_ptr(),
        None if tile_off is None else tile_off.data_ptr(),
        rows, tiles, tiles_per_row, threads, k, _emask(nbits), FP.modulus,
        FP.nprime64, FP.one, partial.data_ptr(), out.data_ptr(),
        _build.stream_handle(out.device))
    _build.check(err, "msm")
    msm.launches += (tiles > 0) + (partial is not out)


def msm(segments, nbits: int = 61) -> torch.Tensor:
    """R MSMs of rows given as up to three segments -> (R,) products:
    row r is the product over every segment's terms t of
    points[r, t]^{exps[r, t]}, the same as its concatenated row's."""
    segs = _segments(segments)
    _emask(nbits)
    dev = next(iter(segs[0][1].devices), torch.device("cpu"))
    if dev.type == "cpu":
        return msm_plain(segments, nbits)
    _check_device(dev, "msm")
    return _msm_rows(segs, nbits, dev)


def _msm_rows(segs, nbits: int, dev) -> torch.Tensor:
    rows = segs[0][1].rows
    out = torch.empty(rows, dtype=torch.int64, device=dev)
    if rows == 0:
        return out
    n = sum(e.n for _, e in segs)
    k, threads = geometry(rows * n, rows)
    tiles_per_row = max(1, -(-n // (threads * k)))
    partial = out if tiles_per_row == 1 else torch.empty(
        rows * tiles_per_row, dtype=torch.int64, device=dev)
    desc = [[*p.ptr_stride(), *e.ptr_stride(), e.n] for p, e in segs]
    _launch(desc, None, None, rows, rows * tiles_per_row, tiles_per_row,
            threads, k, nbits, partial, out)
    return out


def msm_ragged(points: torch.Tensor, exps: torch.Tensor, rows: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """MSMs of rows of different lengths, flattened: term i belongs to row
    rows[i] -> (n_rows,) products.  On the card ``rows`` must be
    non-decreasing (each row's terms together, as `commit_many` lays
    them out); a row with no terms gives the identity."""
    for t, what in ((points, "points"), (exps, "exps"), (rows, "rows")):
        if t.dim() != 1 or t.dtype != torch.int64:
            raise ValueError(f"msm_ragged {what}: expected a 1-D int64 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
        if t.numel() > 1 and t.stride(0) != 1:
            raise ValueError(f"msm_ragged {what}: not contiguous")
    if not points.shape == exps.shape == rows.shape:
        raise ValueError("msm_ragged: points, exps and rows differ in "
                         "length")
    if len({points.device, exps.device, rows.device}) > 1:
        raise ValueError("msm_ragged: tensors on different devices")
    if exps.device.type == "cpu":
        from repro_torch.core import group
        return group.msm_ragged_plain(points, exps, rows, n_rows)
    _check_device(exps.device, "msm_ragged")
    return _msm_ragged_rows(points, exps, rows, n_rows)


def _msm_ragged_rows(points, exps, rows, n_rows: int) -> torch.Tensor:
    dev = exps.device
    out = torch.empty(n_rows, dtype=torch.int64, device=dev)
    if n_rows == 0:
        return out
    n = exps.shape[0]
    k, threads = geometry(n, n_rows)
    tile = threads * k
    if n > 1:
        torch._assert_async((rows[1:] >= rows[:-1]).all())
    # each row's first term, then each row's first tile (TB terms a tile)
    term_off = torch.searchsorted(
        rows, torch.arange(n_rows + 1, dtype=torch.int64, device=dev))
    tile_off = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.div(term_off.diff() + (tile - 1), tile,
                           rounding_mode="floor"), 0, out=tile_off[1:])
    tiles = -(-n // tile) + n_rows          # at least tile_off[n_rows]
    partial = torch.empty(tiles, dtype=torch.int64, device=dev)
    _launch([[points.data_ptr(), 0, exps.data_ptr(), 0, n]], term_off,
            tile_off, n_rows, tiles, 0, threads, k, 61, partial, out)
    return out


msm.launches = 0
