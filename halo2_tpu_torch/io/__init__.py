from halo2_tpu_torch.io.serialization import (
    load_circuit_data,
    load_params,
    load_vk,
    load_witness,
    save_circuit_data,
    save_params,
    save_vk,
    save_witness,
)
