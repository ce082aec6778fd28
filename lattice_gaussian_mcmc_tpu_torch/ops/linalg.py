"""Host linear algebra for the lattice layer: the sign-fixed float64 QR.

The JAX package computes this QR on the host for f32 lattices
(`lattice_gaussian_mcmc_tpu/lattices/base.py` `lattice_from_basis`); the
port always does, because the conditional widths sigma_i = sigma / R_ii
inherit R's accuracy.
"""

from __future__ import annotations

import numpy as np


def gso_qr(basis) -> tuple[np.ndarray, np.ndarray]:
    """QR of the basis (columns = basis vectors) in float64 with R_ii > 0.

    Gram-Schmidt vectors are b*_i = R_ii Q[:, i]; the GS norms are diag(R).
    """
    Bh = np.asarray(basis, dtype=np.float64)
    Q, R = np.linalg.qr(Bh)
    sign = np.sign(np.diag(R))
    sign[sign == 0] = 1.0
    return Q * sign[None, :], R * sign[:, None]
