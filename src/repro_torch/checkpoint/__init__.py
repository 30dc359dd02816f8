"""Checkpoints in the JAX package's on-disk format (see checkpoint.py)."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,  # noqa: F401
                                               OptState, latest_step_dir,
                                               restore, restore_params, save)
