"""String -> class registries and the config-driven builder.

The port's own registries, separate from the JAX package's so that torch and
flax classes never collide on names like ``"AnchorDiffAE"``. The type strings
are the JAX package's (``difffacto_tpu/utils/registry.py``), so
``configs/*.py`` build unchanged.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> callable registry with decorator-style registration."""

    def __init__(self, name: str):
        self._name = name
        self._modules: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Register ``module`` under ``name`` (defaults to its __name__).

        Usable as ``@REG.register_module()`` or ``REG.register_module(module=f)``.
        """
        if module is not None:
            key = name or module.__name__
            if key in self._modules:
                raise KeyError(f"{key} already registered in {self._name}")
            self._modules[key] = module
            return module

        def _decorator(mod):
            self.register_module(name=name, module=mod)
            return mod

        return _decorator

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(
                f"'{key}' not found in registry '{self._name}'. "
                f"Available: {sorted(self._modules)}"
            )
        return self._modules[key]


def build_from_cfg(cfg: Any, registry: Registry, **kwargs) -> Any:
    """Build an object from a ``dict(type=..., **params)`` config.

    Dicts with a ``type`` key are looked up in ``registry`` and instantiated
    with the remaining keys plus the ``kwargs`` overrides; other values pass
    through untouched. Keys the constructor does not take are dropped, as in
    the JAX package, so options of the training path that this port does not
    read yet leave the build alone.
    """
    if cfg is None:
        return None
    if isinstance(cfg, str):
        return registry.get(cfg)(**kwargs)
    if not isinstance(cfg, dict):
        return cfg
    cfg = dict(cfg)
    if "type" not in cfg:
        return cfg
    obj_type = cfg.pop("type")
    obj_cls = registry.get(obj_type) if isinstance(obj_type, str) else obj_type
    params = dict(cfg)
    params.update(kwargs)
    sig = inspect.signature(obj_cls)
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        params = {k: v for k, v in params.items() if k in sig.parameters}
    return obj_cls(**params)


# The JAX package's 15 registries (``difffacto_tpu/utils/registry.py:102-116``).
# LOSSES stays empty, as it does in the JAX package.
DATASETS = Registry("DATASETS")
MODELS = Registry("MODELS")
ENCODERS = Registry("ENCODERS")
DECOMPOSERS = Registry("DECOMPOSERS")
DIFFUSIONS = Registry("DIFFUSIONS")
NETS = Registry("NETS")
SCHEDULERS = Registry("SCHEDULERS")
HOOKS = Registry("HOOKS")
LOSSES = Registry("LOSSES")
OPTIMS = Registry("OPTIMS")
SAMPLERS = Registry("SAMPLERS")
METRICS = Registry("METRICS")
SEGMENTORS = Registry("SEGMENTORS")
GENERATORS = Registry("GENERATORS")
DISCRIMINATORS = Registry("DISCRIMINATORS")
