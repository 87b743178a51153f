"""State carried across from the JAX package, as numpy arrays and Python
ints: this module imports neither package.

The JAX package keeps field elements as ``uint32`` arrays of shape
``(16, *batch)``, one 16-bit limb per word, Montgomery form; this package
keeps the same words as ``torch.int32``.  So carrying state across is a
dtype view and an upload.  The caller pulls the arrays out of the JAX
objects with ``numpy.asarray`` and hands them over:

    params_from_numpy(k, np.asarray(p.g), np.asarray(p.g_lagrange),
                      (p.s_g2[0].coeffs, p.s_g2[1].coeffs), device="cpu")
"""

from __future__ import annotations

import numpy as np
import torch

from halo2_tpu_torch.fields.limbs import N_LIMBS
from halo2_tpu_torch.pairing import bn254 as pairing
from halo2_tpu_torch.plonk.keygen import ProvingKey, VerifyingKey
from halo2_tpu_torch.plonk.permutation import PermutationPk, PermutationVk
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.domain import EvaluationDomain
from halo2_tpu_torch.utils.device import require_device


def limbs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """A uint32 limb array (..., 16, *batch) of 16-bit limbs -> the same
    words as a torch.int32 tensor on `device`."""
    device = require_device(device)
    arr = np.array(arr, order="C")          # a writable copy of its own
    if arr.dtype != np.uint32:
        raise TypeError(f"expected uint32 limbs, got {arr.dtype}")
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limb words above 16 bits: not a limb array")
    return torch.from_numpy(arr.view(np.int32)).to(device)


def _g2_point(s_g2):
    """((c0, c1), (c0, c1)) ints, or None -> the pairing module's point."""
    if s_g2 is None:
        return None
    (x0, x1), (y0, y1) = s_g2
    return (pairing.FQ2((int(x0), int(x1))), pairing.FQ2((int(y0), int(y1))))


def params_from_numpy(k: int, g, g_lagrange, s_g2, device="cuda") -> Params:
    """g, g_lagrange: (2, 16, 2^k) uint32 Montgomery affine limb arrays;
    s_g2: the G2 point's coordinates as ((x.c0, x.c1), (y.c0, y.c1))."""
    n = 1 << k
    for name, arr in (("g", g), ("g_lagrange", g_lagrange)):
        if tuple(np.shape(arr)) != (2, N_LIMBS, n):
            raise ValueError(f"{name}: expected shape (2, 16, {n}), got "
                             f"{tuple(np.shape(arr))}")
    return Params(k, limbs_from_numpy(g, device),
                  limbs_from_numpy(g_lagrange, device), _g2_point(s_g2))


def proving_key_from_numpy(cs, degree: int, k: int, *, fixed_lagrange,
                           fixed_coeff, sigmas_lagrange, sigmas_coeff,
                           l0_coeff, l_last_coeff, l_blind_coeff,
                           fixed_commitments, permutation_commitments,
                           config=None, device="cuda"):
    """Rebuild (vk, pk) from a key made elsewhere.

    cs: this package's ConstraintSystem for the circuit, already through
    configure / chunking / selector compression (the caller re-runs those
    on the circuit; they are host code); degree: the constraint degree the
    domain was sized with (before selector compression).  The stacks are
    (16, C, n) uint32 Montgomery limb arrays, the l-polys (16, n); the
    commitments are host affine points (x, y) as ints, or None.
    config: the circuit's configure() result, if the caller has it."""
    device = require_device(device)
    domain = EvaluationDomain(degree, k, device)
    vk = VerifyingKey(domain, cs, list(fixed_commitments),
                      PermutationVk(list(permutation_commitments)), k)
    perm_pk = PermutationPk(limbs_from_numpy(sigmas_lagrange, device),
                            limbs_from_numpy(sigmas_coeff, device))
    pk = ProvingKey(vk, limbs_from_numpy(fixed_lagrange, device),
                    limbs_from_numpy(fixed_coeff, device), perm_pk,
                    limbs_from_numpy(l0_coeff, device),
                    limbs_from_numpy(l_last_coeff, device),
                    limbs_from_numpy(l_blind_coeff, device), config=config)
    return vk, pk
