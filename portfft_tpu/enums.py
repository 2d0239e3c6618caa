"""Public enums of the FFT framework.

Semantics mirror the reference library's public enum surface
(reference src/portfft/enums.hpp:26-86), re-expressed for a JAX runtime.
The four reference execution levels (WORKITEM / SUBGROUP / WORKGROUP /
GLOBAL, enums.hpp:44) map onto the planner's levels:

* ``Level.DIRECT``  — one DFT-matrix matmul; covers the sizes the reference
  solves in work-item registers and most subgroup-level sizes.
* ``Level.FUSED``   — one multi-factor Stockham chain of matmul stages;
  covers reference subgroup + workgroup territory.
* ``Level.GLOBAL``  — four-step split into sub-plans with transposes
  between the passes, for larger transforms (reference GLOBAL).
* ``Level.BLUESTEIN`` — chirp-z fallback for large prime sizes (the reference
  throws for these; we support them).
"""

import enum


class Domain(enum.Enum):
    """Transform domain (reference enums.hpp:26)."""

    REAL = "real"
    COMPLEX = "complex"


class ComplexStorage(enum.Enum):
    """Layout of complex values (reference enums.hpp:28).

    INTERLEAVED_COMPLEX: array-of-structs (re, im adjacent) — also the natural
    representation of a JAX ``complex64/128`` array.
    SPLIT_COMPLEX: struct-of-arrays; the user passes separate re/im buffers.
    """

    INTERLEAVED_COMPLEX = "interleaved_complex"
    SPLIT_COMPLEX = "split_complex"


class Placement(enum.Enum):
    """In-place vs out-of-place execution (reference enums.hpp:30)."""

    IN_PLACE = "in_place"
    OUT_OF_PLACE = "out_of_place"


class Direction(enum.Enum):
    """Transform direction (reference enums.hpp:32)."""

    FORWARD = "forward"
    BACKWARD = "backward"


def inv(direction: Direction) -> Direction:
    """Opposite direction (reference enums.hpp:39)."""
    return (
        Direction.BACKWARD if direction == Direction.FORWARD else Direction.FORWARD
    )


class Level(enum.Enum):
    """Planner-selected implementation level (analogue of enums.hpp:44)."""

    DIRECT = "direct"
    FUSED = "fused"
    GLOBAL = "global"
    BLUESTEIN = "bluestein"


class Layout(enum.Enum):
    """Data layout classification (reference enums.hpp:46-57)."""

    #: Default strides and distance; each transform contiguous, batches
    #: stored one after the other: ``buf[idx + N * batch]``.
    PACKED = "packed"
    #: Arbitrary strides / distance.
    UNPACKED = "unpacked"
    #: ``distance == 1`` and ``stride[-1] == number_of_transforms``:
    #: ``buf[idx * batch_count + batch]``.
    BATCH_INTERLEAVED = "batch_interleaved"
