"""The LM stack's step builders (counterpart of ``repro.train``): the
inference steps."""
from .step import make_prefill_step, make_serve_step  # noqa: F401
