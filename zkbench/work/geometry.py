"""The proof geometry of a chain FCNN cell: the stacked lengths, the
direct-sum opening and the merged IPA length, and the challenge-point
sizes.  A copy of the protocol's layout arithmetic for chain graphs
(input, then qmatmul + zkrelu per layer, then the loss), worked out
from the widths, the batch, the window T and the quantisation alone.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def log2_exact(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    return n.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    widths: Tuple[int, ...]          # d_0 .. d_L
    batch: int
    n_steps: int                     # T
    q_bits: int = 16
    r_bits: int = 8

    def __post_init__(self):
        if len(self.widths) < 3:
            raise ValueError("an FCNN proof needs at least two layers")
        if self.batch != next_pow2(self.batch):
            raise ValueError("the batch must be a power of two")

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    @property
    def pads(self) -> Tuple[int, ...]:
        return tuple(next_pow2(w) for w in self.widths)

    # -- stacked axes (node fastest, then step) ---------------------------
    @property
    def t_pad(self) -> int:
        return next_pow2(self.n_steps)

    @property
    def l_pad(self) -> int:          # one aux slot per zkrelu node
        return next_pow2(self.n_layers)

    @property
    def s_pad(self) -> int:
        return self.t_pad * self.l_pad

    @property
    def d_elem(self) -> int:         # batch x widest padded layer
        return self.batch * max(self.pads[1:])

    @property
    def w_elem(self) -> int:         # widest padded in x out
        return max(self.pads[l - 1] * self.pads[l]
                   for l in range(1, self.n_layers + 1))

    @property
    def d_stack(self) -> int:
        return self.s_pad * self.d_elem

    @property
    def w_stack(self) -> int:
        return self.s_pad * self.w_elem

    @property
    def y_stack(self) -> int:
        return self.t_pad * self.batch * self.pads[-1]

    @property
    def x_len(self) -> int:
        return self.pads[0]

    # -- the one merged opening ------------------------------------------
    def agg_blocks(self) -> Tuple[Tuple[str, int], ...]:
        """(slot, length) in the commitment schema's order: label, the
        two weight slots, the five aux slots, then the two data folds."""
        return (("y", self.y_stack), ("w", self.w_stack),
                ("gw", self.w_stack), ("zpp", self.d_stack),
                ("bq", self.d_stack), ("rz", self.d_stack),
                ("gap", self.d_stack), ("rga", self.d_stack),
                ("x1", self.x_len), ("x2", self.x_len))

    @property
    def agg_len(self) -> int:
        return next_pow2(sum(n for _, n in self.agg_blocks()))

    @property
    def validity_main(self) -> int:  # zkReLU eq. (19), Q-bit statement
        return 2 * self.d_stack * self.q_bits

    @property
    def validity_rem(self) -> int:   # the R-bit remainder statement
        return 2 * self.d_stack * self.r_bits

    @property
    def merged_len(self) -> int:
        return next_pow2(self.agg_len + self.validity_main
                         + self.validity_rem)

    # -- challenge-point sizes --------------------------------------------
    @property
    def lb(self) -> int:
        return log2_exact(self.batch)

    @property
    def la(self) -> int:
        return log2_exact(self.d_elem)

    @property
    def lw(self) -> int:
        return log2_exact(self.w_elem)

    @property
    def lj(self) -> int:             # widest padded in-width
        return log2_exact(max(self.pads[:-1]))

    @property
    def ls(self) -> int:
        return log2_exact(self.s_pad)
