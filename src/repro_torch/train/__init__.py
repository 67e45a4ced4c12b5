"""The LM stack's step builders and optimizer (counterpart of
``repro.train``): the train, prefill and serve steps, AdamW, and the
int8 error-feedback compression (``repro_torch.train.compress``)."""
from .optim import OptConfig, init as opt_init, update as opt_update  # noqa: F401
from .step import (cross_entropy, make_loss_fn, make_prefill_step,  # noqa: F401
                   make_serve_step, make_train_step)
