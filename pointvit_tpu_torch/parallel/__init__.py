"""Device meshes, data, tensor, FSDP, expert, sequence and pipeline
parallelism over ``torch.distributed`` (the counterpart of
``pointvit_tpu.parallel``; one process per device)."""

from pointvit_tpu_torch.parallel.pipeline import (
    pipeline_blocks,
    stack_block_params,
    unstack_block_params,
)
from pointvit_tpu_torch.parallel.sequence import ring_mha, ulysses_mha
from pointvit_tpu_torch.parallel.fsdp import (
    fsdp_shardings,
    per_device_bytes,
    replicated_bytes,
    shard_fsdp,
)
from pointvit_tpu_torch.parallel.expert import (
    init_moe_params,
    moe_ffn,
    moe_load_balance_loss,
)
from pointvit_tpu_torch.parallel.mesh import (
    batch_shard_map,
    batch_sharding,
    make_hybrid_mesh,
    make_mesh,
    make_multihost_mesh,
    replicate,
    shard_batch,
    transformer_tp_shardings,
)

__all__ = [
    "batch_shard_map",
    "batch_sharding",
    "fsdp_shardings",
    "per_device_bytes",
    "replicated_bytes",
    "shard_fsdp",
    "make_hybrid_mesh",
    "make_mesh",
    "make_multihost_mesh",
    "init_moe_params",
    "moe_ffn",
    "moe_load_balance_loss",
    "pipeline_blocks",
    "replicate",
    "ring_mha",
    "stack_block_params",
    "ulysses_mha",
    "unstack_block_params",
    "shard_batch",
    "transformer_tp_shardings",
]
