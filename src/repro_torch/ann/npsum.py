"""f32 sums in numpy's own order, on any torch device.

The reference decides graph edges with numpy: ``np.sum((a - b) ** 2,
axis=1)`` of f32 rows, compared with ``<`` and sorted with
``np.argsort``.  A different summation order changes the last bit of a
distance, and with it an occlusion decision or a tie order.  So the
port sums in numpy's order, with explicit elementwise adds (never
``torch.sum``, whose order is its own), and reproduces those decisions
bit for bit on the card and on the CPU.

numpy's pairwise sum of ``n`` f32 values (``pairwise_sum`` in its
``loops_utils``; the order of ``np.sum`` of a 1-d array and of each row
of ``np.sum(a, axis=1)``):

* ``n < 8``: one running sum;
* ``8 <= n <= 128``: eight running sums ``r[j] += a[8 i + j]``, combined
  as ``((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))``, then the
  ``n % 8`` tail added one at a time;
* ``n > 128``: split at ``n2 = n // 2 - (n // 2) % 8`` and add the two
  halves' sums.
"""

from __future__ import annotations

import torch

__all__ = ["np_sum_f32", "np_sq_dist"]


def _pairwise(a: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    if n < 8:
        s = a[..., lo]
        for i in range(1, n):
            s = s + a[..., lo + i]
        return s
    if n <= 128:
        m = n - n % 8
        r = a[..., lo:lo + 8]
        for i in range(8, m, 8):
            r = r + a[..., lo + i:lo + i + 8]
        s = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
            ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            s = s + a[..., lo + i]
        return s
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(a, lo, n2) + _pairwise(a, lo + n2, n - n2)


def np_sum_f32(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum f32 ``a`` over ``dim`` in numpy's pairwise order: bit-equal to
    ``np.sum`` of a CPU copy, on either device."""
    if a.dtype != torch.float32:
        raise TypeError(f"np_sum_f32 takes float32, got {a.dtype}")
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    if n == 0:
        return torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    return _pairwise(a, 0, n)


def np_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.sum((a - b) ** 2, axis=-1)`` of f32 rows (broadcast), bit for
    bit: the difference, its square (``diff * diff``, as numpy's ``** 2``)
    and the pairwise sum."""
    diff = a - b
    return np_sum_f32(diff * diff)
