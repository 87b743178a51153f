"""BN254 (alt_bn128 / bn256) field definitions.

  Fr = scalar field (circuit values, polynomial coefficients)
  Fq = base field (G1 point coordinates)

`fr(device)` / `fq(device)` give the `Field` context for a device; there
is no default device.
"""

import functools

import torch

# BN254 scalar field modulus r
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field modulus q
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# 2-adicity of Fr: r - 1 = 2**28 * t
FR_S = 28
# generator of the multiplicative group of Fr (same as pairing_bn256: 7)
FR_GENERATOR = 7
# primitive 2**28-th root of unity: g**((r-1)/2**28)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MODULUS - 1) >> FR_S, FR_MODULUS)
# cube root of unity used as the coset generator zeta ("g_coset"), mirroring
# halo2_proofs/src/poly/domain.rs:88-89 (zeta**3 == 1)
FR_ZETA = pow(FR_GENERATOR, (FR_MODULUS - 1) // 3, FR_MODULUS)

# BN254 G1: y^2 = x^3 + 3 over Fq, generator (1, 2)
G1_B = 3
G1_GEN = (1, 2)


@functools.lru_cache(maxsize=None)
def _field(name: str, device: str):
    from halo2_tpu_torch.fields.limbs import Field
    modulus = {"Fr": FR_MODULUS, "Fq": FQ_MODULUS}[name]
    return Field(modulus, name, torch.device(device))


def fr(device):
    """The Fr context that allocates on `device`."""
    return _field("Fr", str(torch.device(device)))


def fq(device):
    """The Fq context that allocates on `device`."""
    return _field("Fq", str(torch.device(device)))
