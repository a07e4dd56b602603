"""The system under test, ``repro_torch``, as the drivers reach it: its
configuration object, its entry points, its kernel counters, and the
benchmark's own spans around the calls into its model layer.

Nothing else in the benchmark imports the program.  The plain references
never do.
"""

from __future__ import annotations

import contextlib
import dataclasses

from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import lm


def model_config(config: dict) -> ModelConfig:
    """The program's configuration: every key of the file that is a field
    of ``ModelConfig``, lists as tuples."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config.items() if k in names}
    return ModelConfig(**kw)


def param_specs(cfg: ModelConfig):
    return lm.lm_param_specs(cfg)


def flash_launches() -> dict:
    """The flash kernels' call counters: forward and backward."""
    return {"forward": flash_kernel.LAUNCHES,
            "backward": flash_kernel.BACKWARD_LAUNCHES}


@contextlib.contextmanager
def patched(module, name: str, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield original
    finally:
        setattr(module, name, original)


def spanned(span: str, on_call=None):
    """A wrapper maker: the call inside the profiler range ``span``, with
    ``on_call(*args)`` seen first."""
    def wrap(fn):
        def inner(*args, **kwargs):
            if on_call is not None:
                on_call(*args, **kwargs)
            with record_function(span):
                return fn(*args, **kwargs)
        return inner
    return wrap
