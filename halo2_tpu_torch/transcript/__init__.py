from halo2_tpu_torch.transcript.blake2b import (
    Blake2bRead,
    Blake2bWrite,
    point_from_bytes,
    point_to_bytes,
    scalar_from_bytes,
    scalar_to_bytes,
)
