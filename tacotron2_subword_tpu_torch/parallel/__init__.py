from tacotron2_subword_tpu_torch.parallel.mesh import (
    Mesh,
    collective_barrier,
    gather_train_state,
    hifigan_param_sharding,
    make_mesh,
    make_parallel_train_step,
    shard_batch,
    shard_train_state,
    tacotron_param_sharding,
    train_state_shardings,
)

__all__ = [
    "Mesh",
    "collective_barrier",
    "gather_train_state",
    "hifigan_param_sharding",
    "make_mesh",
    "make_parallel_train_step",
    "shard_batch",
    "shard_train_state",
    "tacotron_param_sharding",
    "train_state_shardings",
]
