"""StreamSpec: the software form of the SSR address-generator configuration.

The paper's AGU (Fig. 3) exposes ten memory-mapped registers: a status register
(pointer, #enabled dims, direction, done flag), a ``repeat`` register, and
``bound0-3`` / ``stride0-3`` for up to four nested loop dimensions.  A
:class:`StreamSpec` is exactly that configuration, expressed in elements rather
than bytes (the TPU adaptation streams *blocks*; see ``core/ssr.py``).

Conventions
-----------
* ``bounds``/``strides`` are ordered **outermost first** (``bounds[-1]`` is the
  innermost loop), matching the paper's ``L_1 .. L_d`` with ``i = 1`` outermost.
* ``repeat = r`` emits each datum ``r`` times back-to-back (the paper's repeat
  register, used when one loaded value feeds several compute instructions).
* A stream is read-only or write-only for its whole lifetime (paper §2.3: "a
  stream cannot be used to interleave read and write operations").
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterator, Sequence, Tuple

MAX_DIMS = 4  # the paper's AGU supports four nested loop dimensions (§3.1)


class Direction(enum.Enum):
    READ = "read"
    WRITE = "write"


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Affine address pattern for one SSR data-mover lane.

    Addresses are emitted (outermost-first iteration order)::

        for i_1 in range(bounds[0]):
          ...
            for i_d in range(bounds[-1]):
              addr = base + sum(i_k * strides[k])   # emitted ``repeat`` times
    """

    bounds: Tuple[int, ...]
    strides: Tuple[int, ...]
    base: int = 0
    repeat: int = 1
    direction: Direction = Direction.READ

    def __post_init__(self) -> None:
        if not (1 <= len(self.bounds) <= MAX_DIMS):
            raise ValueError(
                f"SSR AGU supports 1..{MAX_DIMS} loop dims, got {len(self.bounds)}"
            )
        if len(self.strides) != len(self.bounds):
            raise ValueError("bounds and strides must have equal length")
        if any(b <= 0 for b in self.bounds):
            raise ValueError(f"loop bounds must be positive, got {self.bounds}")
        if self.repeat < 1:
            raise ValueError("repeat must be >= 1")
        if self.direction == Direction.WRITE and self.repeat != 1:
            # Writing the same datum repeatedly is meaningless; the paper's
            # repeat register only applies to read streams.
            raise ValueError("write streams cannot use repeat > 1")

    # -- geometry ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.bounds)

    @property
    def num_iterations(self) -> int:
        """Total loop-nest iterations  Π L_i  (pattern length before repeat)."""
        return math.prod(self.bounds)

    @property
    def num_transactions(self) -> int:
        """Register-file transactions seen by the core ( Π L_i · repeat )."""
        return self.num_iterations * self.repeat

    @property
    def num_memory_accesses(self) -> int:
        """Memory-side accesses. Repeated data is fetched once (FIFO reuse)."""
        return self.num_iterations

    def addresses(self) -> Iterator[int]:
        """Reference enumeration of the emitted address sequence.

        This is the plain-Python oracle; ``core/agu.py`` provides the
        vectorised equivalent used inside kernels/tests.
        """
        idx = [0] * self.ndim
        total = self.num_iterations
        for _ in range(total):
            addr = self.base + sum(i * s for i, s in zip(idx, self.strides))
            for _ in range(self.repeat):
                yield addr
            # odometer increment, innermost fastest
            for k in reversed(range(self.ndim)):
                idx[k] += 1
                if idx[k] < self.bounds[k]:
                    break
                idx[k] = 0

    def address_range(self) -> Tuple[int, int]:
        """(min, max) element address touched — for overlap/race checks."""
        lo = self.base + sum(
            (b - 1) * s for b, s in zip(self.bounds, self.strides) if s < 0
        )
        hi = self.base + sum(
            (b - 1) * s for b, s in zip(self.bounds, self.strides) if s > 0
        )
        return lo, hi

    def touches(self, other: "StreamSpec") -> bool:
        """Conservative overlap test between two streams' address ranges."""
        a_lo, a_hi = self.address_range()
        b_lo, b_hi = other.address_range()
        return not (a_hi < b_lo or b_hi < a_lo)

    # -- derived views ----------------------------------------------------
    def with_direction(self, direction: Direction) -> "StreamSpec":
        return dataclasses.replace(self, direction=direction)

    def config_writes(self) -> int:
        """Number of memory-mapped config stores needed to program this lane.

        Paper Fig. 4 / Eq. (1): each lane is programmed with ``bound``/
        ``stride`` per enabled dim plus the status/trigger write.  Used by the
        ISA model's setup accounting.
        """
        return 2 * self.ndim + 1


def contiguous(n: int, *, base: int = 0,
               direction: Direction = Direction.READ) -> StreamSpec:
    """1-D unit-stride stream — the dot-product pattern of Fig. 4."""
    return StreamSpec(bounds=(n,), strides=(1,), base=base, direction=direction)


def strided_2d(rows: int, cols: int, row_stride: int, *, base: int = 0,
               col_stride: int = 1,
               direction: Direction = Direction.READ) -> StreamSpec:
    """2-D pattern (row-major matrix walk), e.g. GEMV operand streaming."""
    return StreamSpec(bounds=(rows, cols), strides=(row_stride, col_stride),
                      base=base, direction=direction)


def validate_no_race(reads: Sequence[StreamSpec],
                     writes: Sequence[StreamSpec]) -> None:
    """Enforce the paper's coherence rule (§2.3).

    The data mover prefetches ahead, so a write stream must not touch a memory
    range concurrently used by a read stream ("write operations shall not be
    performed on a memory range that is currently used in a read stream").
    """
    for w in writes:
        for r in reads:
            if w.touches(r):
                raise ValueError(
                    "SSR race: write stream overlaps a live read stream "
                    f"(write range {w.address_range()}, read range "
                    f"{r.address_range()}); the data mover's proactive "
                    "prefetch makes this incoherent (paper §2.3)"
                )
