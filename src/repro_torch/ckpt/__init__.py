"""``repro_torch.ckpt`` -- the step-directory checkpointer (counterpart
of ``repro.ckpt``)."""
from .checkpointer import (Checkpointer, CheckpointError,  # noqa: F401
                           CheckpointIntegrityError)
