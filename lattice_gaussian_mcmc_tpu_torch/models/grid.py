"""Grid-lattice site indexing and adjacency (a copy of the JAX package's
`models/grid.py`): dense adjacency of a d-dimensional nearest-neighbour
grid with optional periodic wrap, on the host."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def site_to_coords(site: int, shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(np.unravel_index(site, shape))


def coords_to_site(coords: Sequence[int], shape: Sequence[int]) -> int:
    return int(np.ravel_multi_index(coords, shape))


def grid_adjacency(shape: Sequence[int], periodic: bool = False) -> np.ndarray:
    """Dense (N, N) 0/1 adjacency of the nearest-neighbour grid graph."""
    shape = tuple(shape)
    N = int(np.prod(shape))
    W = np.zeros((N, N), dtype=np.float64)
    for site in range(N):
        coords = np.array(site_to_coords(site, shape))
        for axis in range(len(shape)):
            for delta in (-1, 1):
                nb = coords.copy()
                nb[axis] += delta
                if periodic:
                    nb[axis] %= shape[axis]
                elif not (0 <= nb[axis] < shape[axis]):
                    continue
                W[site, coords_to_site(nb, shape)] = 1.0
    return W
