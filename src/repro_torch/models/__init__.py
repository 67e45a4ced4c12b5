"""The seed-era LM stack's models (counterpart of ``repro.models``): the
parameter tree as :class:`~repro_torch.models.layers.Params` modules,
``forward`` for prefill, ``init_cache``/``decode_step`` for serving."""
from .model import init_model, forward, xlstm_kinds  # noqa: F401
from .decode import init_cache, decode_step  # noqa: F401
