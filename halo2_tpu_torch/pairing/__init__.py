from halo2_tpu_torch.pairing.bn254 import (
    FQ2,
    FQ12,
    G2_GEN,
    g2_add,
    g2_mul,
    g2_neg,
    pairing,
    pairing_check,
)
