"""H-band context parallelism for scoring (counterpart of
``shard_batch_spatial`` and ``spatial_constraint`` in
``seg2eye_tpu/parallel/sharding.py``).

Under ``--spatial_shard`` every rank of a process group holds the whole
batch and the whole weights, and computes one contiguous band of rows of
each activation: a bs1 request then keeps every GPU busy, where sharding
the batch would idle all but one.  The layout follows the JAX package's
per-resolution rule: an activation of height H is split into N bands
where N divides H, and is whole on every rank where not (the generator's
small latent resolutions), so the layout switches between resolutions
(``Bands.at``; ``place``).

What crosses a band edge is exchanged or summed explicitly:

  * a conv reads ``padding`` rows above and ``k - stride - padding`` rows
    below its band from the neighbouring ranks (``Band.pad_rows``; zero
    rows at the image's edges, the conv's own padding);
  * the fused SPADE+Style kernel reads two rows of x and of the seg map
    beyond each interior edge (``Band.extend``): its seg MLP's 3x3 conv
    and its gamma/beta 3x3 conv need one each, while at the image's edges
    the kernel's own zero padding stays right; the band's own rows of its
    output are kept;
  * every statistic over H (batch statistics over (N, H, W), instance
    statistics over (H, W)) sums over the bands (``Band.var_mean``);
  * what reads the whole map (the encoder's linear layers, the fake that
    is scored) gathers it (``Band.gather``).

A band narrower than the rows an exchange needs gathers the whole map and
takes its rows.  Only ``all_reduce`` is used, as in
``parallel.data_parallel``: an exchange or a gather all-reduces a
zero-filled buffer in which each rank fills its own rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


class Bands:
    """The H-band layout over ``group`` (the default group when None)."""

    def __init__(self, group=None):
        self.group = dist.group.WORLD if group is None else group
        self.n = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def at(self, h: int) -> Optional["Band"]:
        """This rank's band of a map of height ``h``, or None where the
        map is whole on every rank (N does not divide ``h``)."""
        return Band(self, h) if h % self.n == 0 else None


def at(bands: Optional[Bands], h: int) -> Optional["Band"]:
    """``bands.at(h)``; None without bands."""
    return None if bands is None else bands.at(h)


def place(x: torch.Tensor, old: Optional["Band"], new: Optional["Band"]
          ) -> torch.Tensor:
    """x (NCHW), laid out as ``old`` says (a band, or whole for None), in
    the layout ``new`` says, at the same height."""
    if old is None:
        return x if new is None else new.take(x)
    return old.gather(x) if new is None else x


class Band:
    """Rows [lo, lo + rows) of a map of ``full`` rows (dim 2, NCHW)."""

    def __init__(self, bands: Bands, full: int):
        self.bands, self.full = bands, full
        self.rows = full // bands.n
        self.lo = bands.index * self.rows

    @property
    def group(self):
        return self.bands.group

    def _span(self, halo: int) -> Tuple[int, int]:
        return (max(self.lo - halo, 0),
                min(self.lo + self.rows + halo, self.full))

    def take(self, x: torch.Tensor, halo: int = 0) -> torch.Tensor:
        """This band's rows of a whole map, with up to ``halo`` rows on
        each side within the image."""
        a, b = self._span(halo)
        return x[:, :, a:b]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from every rank's band."""
        n, i = self.bands.n, self.bands.index
        buf = x.new_zeros((n, *x.shape))
        buf[i] = x
        dist.all_reduce(buf, group=self.group)
        return torch.cat(buf.unbind(0), 2)

    def extend(self, x: torch.Tensor, k: int) -> Tuple[torch.Tensor, int]:
        """The band with up to ``k`` neighbouring rows on each side, none
        beyond the image's edges -> (rows, how many of them are above),
        as ``take(whole, k)`` would give them."""
        top = self.lo - self._span(k)[0]
        if self.rows < k:
            return self.take(self.gather(x), k), top
        n, i = self.bands.n, self.bands.index
        buf = x.new_zeros((n, 2, *x[:, :, :k].shape))
        buf[i, 0], buf[i, 1] = x[:, :, :k], x[:, :, -k:]
        dist.all_reduce(buf, group=self.group)
        parts = ([buf[i - 1, 1]] if i > 0 else []) + [x] + (
            [buf[i + 1, 0]] if i < n - 1 else [])
        return torch.cat(parts, 2), top

    def pad_rows(self, x: torch.Tensor, above: int, below: int
                 ) -> torch.Tensor:
        """The band with ``above`` rows above and ``below`` below: the
        neighbours' rows, zeros beyond the image's edges (a conv's
        padding)."""
        k = max(above, below)
        if k == 0:
            return x
        ext, top = self.extend(x, k)
        bottom = ext.shape[2] - x.shape[2] - top
        ext = torch.nn.functional.pad(ext, (0, 0, k - top, k - bottom))
        return ext[:, :, k - above:ext.shape[2] - (k - below)]

    def var_mean(self, x: torch.Tensor, dims) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        """-> (biased variance, mean) over ``dims`` (which hold H) of the
        whole map, from every rank's band."""
        from seg2eye_tpu_torch.parallel import data_parallel as dp

        var, mean, _ = dp.synced_var_mean(x, dims, over=self.group)
        return var, mean
