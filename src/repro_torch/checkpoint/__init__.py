from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager, latest_step, load_flat, load_manifest, load_named,
    restore, save, unflatten,
)
