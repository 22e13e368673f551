"""Operations and bytes of one launch of the port's hand-written kernels,
from the logical shape the wrapper records: each input read once, each
output written once, 2 flops a multiply-add and 8 a complex one."""

from __future__ import annotations


def b1(matrices: int, n: int, real_bytes: int):
    """(bytes, flops) of the Gauss-Jordan inverse and log-determinant of
    `matrices` complex n x n matrices (real parts of `real_bytes`): the
    matrices in, the inverses, the signs (complex) and the log-moduli
    (real) out; n^3 complex multiply-adds a matrix."""
    item = 2 * real_bytes
    nbytes = 2 * matrices * n * n * item + matrices * (item + real_bytes)
    return nbytes, 8.0 * n**3 * matrices


def jet(t: int, rows: int, d_in: int, d_out: int, mix_groups: int = 0,
        real_bytes: int = 4):
    """(bytes, flops) of the dense tanh jet rule on (t + 2) columns (value,
    t tangents, Laplacian) of `rows` rows: the jet and the weights in, the
    output jet out, and with the mix rule the row-constant jet of each of
    its `mix_groups` walkers in."""
    cols = t + 2
    nbytes = real_bytes * (cols * rows * d_in + d_in * d_out + d_out
                           + cols * rows * d_out + cols * mix_groups * d_out)
    return nbytes, 2.0 * cols * rows * d_in * d_out
