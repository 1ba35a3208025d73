"""N-dimensional Morton (z-order) index: the static cutout plan.

A trimmed copy of the reference curve (OCP, Burns et al. 2013, §3):
cuboids are indexed by bit-interleaving their per-dimension grid offsets,
with unequal per-dimension bit widths for anisotropic grids (exhausted
dimensions drop out of the interleave, so the index stays dense in
``[0, prod(2^bits))``).  Pure numpy on the host — the plan is computed
before any device work, and only the resulting cell list moves to the card.
`range_decompose` and the run helpers serve the object index and the
cutout plan, the 2-d Hilbert decode serves `kernels/morton_matmul`'s tile
orders, `partition_curve` with `owner_of` cuts a curve into the ranks'
or hosts' segments (`core.distributed`, `data.pipeline`), and `Partition`
is the movable boundary list the cluster's `Router` owns by.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np

Runs = List[Tuple[int, int]]  # half-open [start, stop) morton-index runs


@functools.lru_cache(maxsize=None)
def bit_placement(bits: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    """(dim, src_bit) per output bit, LSB first, round-robin over dims."""
    placement = []
    for level in range(max(bits) if bits else 0):
        for dim, b in enumerate(bits):
            if level < b:
                placement.append((dim, level))
    return tuple(placement)


def grid_bits(grid_shape: Sequence[int]) -> Tuple[int, ...]:
    """Per-dim bit widths for a cuboid-grid shape (rounded up to pow2)."""
    out = []
    for s in grid_shape:
        if s <= 0:
            raise ValueError(f"grid dim must be positive, got {grid_shape}")
        out.append(int(np.ceil(np.log2(s))) if s > 1 else 0)
    return tuple(out)


def morton_encode(coords, bits: Tuple[int, ...]) -> np.ndarray:
    """Vectorized encode. coords: (..., d) int array -> (...) int64."""
    coords = np.asarray(coords, dtype=np.int64)
    out = np.zeros(coords.shape[:-1], dtype=np.int64)
    for pos, (dim, src_bit) in enumerate(bit_placement(bits)):
        out |= ((coords[..., dim] >> src_bit) & 1) << pos
    return out


def morton_decode(idx, bits: Tuple[int, ...]) -> np.ndarray:
    """Vectorized decode. idx: (...) int -> (..., d) int64."""
    idx = np.asarray(idx, dtype=np.int64)
    out = np.zeros(idx.shape + (len(bits),), dtype=np.int64)
    for pos, (dim, src_bit) in enumerate(bit_placement(bits)):
        out[..., dim] |= ((idx >> pos) & 1) << src_bit
    return out


def total_bits(bits: Tuple[int, ...]) -> int:
    return int(sum(bits))


def range_decompose(lo: Sequence[int], hi: Sequence[int],
                    bits: Tuple[int, ...], max_runs: int | None = None) -> Runs:
    """Decompose the axis-aligned box [lo, hi) into contiguous Morton runs.

    Recursive descent over the implicit 2^d tree of the interleave layout:
    cells fully inside the box emit one run, disjoint cells prune, partial
    cells recurse, and adjacent runs merge, so an aligned box is one run.
    ``max_runs`` greedily merges the nearest runs past that many
    (`coarsen_runs`).
    """
    lo = [int(x) for x in lo]
    hi = [int(x) for x in hi]
    d = len(bits)
    if len(lo) != d or len(hi) != d:
        raise ValueError("lo/hi rank mismatch with bits")
    for dim in range(d):
        if not (0 <= lo[dim] <= hi[dim] <= (1 << bits[dim])):
            raise ValueError(
                f"box [{lo},{hi}) out of grid range for bits={bits}")
        if lo[dim] == hi[dim]:
            return []

    placement = bit_placement(bits)
    nbits = len(placement)
    runs: Runs = []

    # Iterative DFS; state = (pos, start_index, cell_lo tuple). pos counts
    # from the MSB side: output bit index = nbits - 1 - pos.
    stack = [(0, 0, tuple(0 for _ in range(d)))]
    while stack:
        pos, start, cell_lo = stack.pop()
        span = 1 << (nbits - pos)  # indices covered by this cell
        remaining = [0] * d
        for p in range(pos, nbits):
            dim, _ = placement[nbits - 1 - p]
            remaining[dim] += 1
        contained = True
        disjoint = False
        for dim in range(d):
            c_lo = cell_lo[dim]
            c_hi = c_lo + (1 << remaining[dim])
            if c_hi <= lo[dim] or c_lo >= hi[dim]:
                disjoint = True
                break
            if not (lo[dim] <= c_lo and c_hi <= hi[dim]):
                contained = False
        if disjoint:
            continue
        if contained or pos == nbits:
            if runs and runs[-1][1] == start:
                runs[-1] = (runs[-1][0], start + span)
            else:
                runs.append((start, start + span))
            continue
        dim, src_bit = placement[nbits - 1 - pos]
        half = 1 << src_bit
        hi_cell = list(cell_lo)
        hi_cell[dim] += half
        # child 1 first so child 0 pops first (curve order, for the merge)
        stack.append((pos + 1, start + span // 2, tuple(hi_cell)))
        stack.append((pos + 1, start, cell_lo))

    if max_runs is not None and len(runs) > max_runs:
        runs = coarsen_runs(runs, max_runs)
    return runs


def coarsen_runs(runs: Runs, max_runs: int) -> Runs:
    """Merge nearest runs until len <= max_runs (reads extra, never less)."""
    runs = sorted(runs)
    while len(runs) > max_runs:
        gaps = [(runs[i + 1][0] - runs[i][1], i) for i in range(len(runs) - 1)]
        _, i = min(gaps)
        runs[i:i + 2] = [(runs[i][0], runs[i + 1][1])]
    return runs


def runs_to_indices(runs: Runs) -> np.ndarray:
    """Expand runs to a flat int64 array of morton indices (curve order)."""
    if not runs:
        return np.zeros((0,), dtype=np.int64)
    return np.concatenate([np.arange(a, b, dtype=np.int64) for a, b in runs])


def indices_to_runs(cells: Sequence[int]) -> Runs:
    """Collapse *sorted* morton indices into minimal contiguous runs (the
    inverse of `runs_to_indices`)."""
    runs: Runs = []
    for m in cells:
        m = int(m)
        if runs and runs[-1][1] == m:
            runs[-1] = (runs[-1][0], m + 1)
        else:
            runs.append((m, m + 1))
    return runs


def morton_encode_torch(coords, bits: Tuple[int, ...]):
    """`morton_encode` on an int64 tensor (..., d), on its own device."""
    out = coords.new_zeros(coords.shape[:-1])
    for pos, (dim, src_bit) in enumerate(bit_placement(bits)):
        out |= ((coords[..., dim] >> src_bit) & 1) << pos
    return out


def hilbert_decode_2d(t, order: int):
    """Vectorized 2-d Hilbert curve decode: t -> (x, y) on a 2^order grid.

    Every step of the curve moves to a grid neighbour, the property a
    capacity-1 panel-reuse schedule wants (`kernels/morton_matmul`).
    """
    t = np.asarray(t, dtype=np.int64)
    x = np.zeros_like(t)
    y = np.zeros_like(t)
    tt = t.copy()
    for s in range(order):
        rx = (tt >> 1) & 1
        ry = (tt ^ rx) & 1
        swap = ry == 0  # rotate the quadrant
        flip = swap & (rx == 1)
        side = 1 << s
        x_f = np.where(flip, side - 1 - x, x)
        y_f = np.where(flip, side - 1 - y, y)
        x_r = np.where(swap, y_f, x_f)
        y_r = np.where(swap, x_f, y_f)
        x = x_r + rx * side
        y = y_r + ry * side
        tt >>= 2
    return x, y


def partition_curve(n_cells: int, n_parts: int) -> List[Tuple[int, int]]:
    """Partition [0, n_cells) of the curve into n_parts contiguous segments
    (paper §4.1): the first ``n_cells % n_parts`` take one extra cell."""
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    base, rem = divmod(n_cells, n_parts)
    parts = []
    start = 0
    for i in range(n_parts):
        size = base + (1 if i < rem else 0)
        parts.append((start, start + size))
        start += size
    return parts


def owner_of(idx, n_cells: int, n_parts: int):
    """Owning segment of morton index(es) under `partition_curve`; scalar
    in, scalar out (`Partition.owner` of the even split, so ownership
    stays total when ``n_parts > n_cells``)."""
    return Partition.even(n_cells, n_parts).owner(idx)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Explicit contiguous partition of the curve [0, n_cells).

    ``bounds`` has ``n_parts + 1`` non-decreasing entries: part ``i`` owns
    the half-open segment ``[bounds[i], bounds[i+1])``.  This is the
    ownership function made *movable* (paper §6 "dynamically redistribute
    data"): `partition_curve` is the even default, `balanced` re-cuts the
    boundaries by occupancy, and `moves` diffs two partitions into the
    segment migrations a rebalance must perform.  Empty segments (equal
    adjacent bounds) are legal everywhere — a node may own nothing at a
    resolution — and `owner`/`split` skip them.
    """

    bounds: Tuple[int, ...]

    def __post_init__(self):
        bounds = tuple(int(b) for b in self.bounds)
        object.__setattr__(self, "bounds", bounds)
        if len(bounds) < 2:
            raise ValueError("bounds needs >= 2 entries (one segment)")
        if bounds[0] != 0:
            raise ValueError(f"bounds must start at 0, got {bounds[0]}")
        if any(a > b for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"bounds must be non-decreasing: {bounds}")
        object.__setattr__(self, "_bounds_arr", np.asarray(bounds, dtype=np.int64))

    @staticmethod
    def even(n_cells: int, n_parts: int) -> "Partition":
        """The `partition_curve` default as an explicit boundary list."""
        return Partition.from_segments(partition_curve(n_cells, n_parts))

    @staticmethod
    def from_segments(segments: Sequence[Tuple[int, int]]) -> "Partition":
        bounds = [0]
        for a, b in segments:
            if a != bounds[-1]:
                raise ValueError(f"segments not contiguous at {a}")
            bounds.append(b)
        return Partition(tuple(bounds))

    @staticmethod
    def balanced(cells: Sequence[int], n_cells: int, n_parts: int) -> "Partition":
        """Occupancy-balanced boundaries: ~equal key counts per part.

        ``cells`` is the (multiset of) occupied morton indexes — one entry
        per stored key, so multi-channel cells weigh more.  Boundaries are
        quantile cuts of the sorted occupancy; an empty occupancy falls
        back to the even split.
        """
        if n_parts <= 0:
            raise ValueError("n_parts must be positive")
        cells = np.sort(np.asarray(cells, dtype=np.int64))
        if cells.size == 0:
            return Partition.even(n_cells, n_parts)
        if cells[0] < 0 or cells[-1] >= n_cells:
            raise ValueError("occupied cell out of range")
        cuts = []
        for i in range(1, n_parts):
            ideal = (i * cells.size) // n_parts
            v = int(cells[ideal])
            # A cut can only land on a cell boundary; duplicates (multi-
            # channel keys) make the two candidate boundaries around the
            # ideal count differ — take whichever splits closer to it.
            below = int(np.searchsorted(cells, v, side="left"))
            above = int(np.searchsorted(cells, v, side="right"))
            cuts.append(v if ideal - below < above - ideal else v + 1)
        cuts = np.minimum.accumulate(np.minimum(cuts, n_cells)[::-1])[::-1]
        cuts = np.maximum.accumulate(cuts)  # keep bounds non-decreasing
        return Partition((0, *(int(c) for c in cuts), int(n_cells)))

    @property
    def n_parts(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_cells(self) -> int:
        return self.bounds[-1]

    def segments(self) -> List[Tuple[int, int]]:
        return list(zip(self.bounds[:-1], self.bounds[1:]))

    def owner(self, idx):
        """Owning part of morton index(es); scalar in, scalar out.

        ``searchsorted(..., 'right') - 1`` lands on the *last* segment
        whose start is <= idx, which is exactly the non-empty one — empty
        segments (zero span) can never win, so ownership stays total even
        when ``n_parts > n_cells`` or rebalanced bounds collapse a node's
        segment to nothing.
        """
        arr = np.asarray(idx, dtype=np.int64)
        if arr.size and (arr.min() < 0 or arr.max() >= max(self.n_cells, 1)):
            raise ValueError(f"morton index out of range [0, {self.n_cells})")
        owner = np.searchsorted(self._bounds_arr, arr, side="right") - 1
        return owner if arr.ndim else int(owner)

    def split(self, start: int, stop: int) -> List[Tuple[int, int, int]]:
        """Split curve run [start, stop) at partition boundaries.

        Returns [(part, start, stop), ...] in curve order; every piece is
        non-empty and wholly owned.  Empty segments are skipped rather
        than walked into (the historical ``node += 1`` scan emitted
        zero-length pieces and could run off the segment list).
        """
        if not (0 <= start <= stop <= self.n_cells):
            raise ValueError(f"run [{start},{stop}) outside [0, {self.n_cells})")
        pieces: List[Tuple[int, int, int]] = []
        while start < stop:
            part = int(np.searchsorted(self._bounds_arr, start, side="right")) - 1
            piece_stop = min(stop, self.bounds[part + 1])
            pieces.append((part, start, piece_stop))
            start = piece_stop
        return pieces

    def moves(self, new: "Partition") -> List[Tuple[int, int, int, int]]:
        """Diff against ``new``: [(start, stop, src, dst), ...] runs whose
        owner changes — the segment migrations a rebalance performs."""
        if new.n_cells != self.n_cells:
            raise ValueError("partitions cover different curves")
        cuts = sorted(set(self.bounds) | set(new.bounds))
        out: List[Tuple[int, int, int, int]] = []
        for a, b in zip(cuts, cuts[1:]):
            if a == b:
                continue
            src, dst = self.owner(a), new.owner(a)
            if src == dst:
                continue
            if out and out[-1][1] == a and out[-1][2:] == (src, dst):
                out[-1] = (out[-1][0], b, src, dst)
            else:
                out.append((a, b, src, dst))
        return out
