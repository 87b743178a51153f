from halo2_tpu_torch.multiopen.common import (
    BatchVerifier,
    HostMSM,
    PairMSM,
    ProverQuery,
    VerifierQuery,
    decider_verify,
)
