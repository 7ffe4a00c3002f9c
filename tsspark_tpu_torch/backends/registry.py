"""ForecastBackend plugin registry of the port.

Backends are classes implementing fit/predict over padded array batches;
selection is by name with optional keyword overrides.

Built-ins:
  * "cuda" — the batched PyTorch path; its forward, interval, loss and
    line-search passes are hand-written CUDA kernels (``device="cpu"``
    runs their plain PyTorch versions instead).
  * "cpu" — per-series scipy L-BFGS-B on the plain loss: the parity
    oracle of the batched fit, and the resilient route's degradation
    backend (``degraded_backend``).
"""

from __future__ import annotations

import abc
from typing import Dict, Optional, Type

from tsspark_tpu_torch.config import ProphetConfig, SolverConfig


class ForecastBackend(abc.ABC):
    """A strategy for executing batched Prophet fits and forecasts."""

    name: str = "abstract"

    def __init__(
        self,
        config: ProphetConfig = ProphetConfig(),
        solver_config: SolverConfig = SolverConfig(),
        **kwargs,
    ):
        self.config = config
        self.solver_config = solver_config

    @abc.abstractmethod
    def fit(self, ds, y, mask=None, cap=None, floor=None, regressors=None,
            init=None, conditions=None):
        """Fit a (B, T) batch; returns a FitState."""

    @abc.abstractmethod
    def predict(self, state, ds, cap=None, regressors=None, seed=0,
                num_samples=None, conditions=None):
        """Forecast a fitted state on a time grid; returns dict of arrays."""

    @abc.abstractmethod
    def components(self, state, ds, cap=None, regressors=None,
                   conditions=None):
        """Per-block component arrays for a fitted state."""


_REGISTRY: Dict[str, Type[ForecastBackend]] = {}


def register_backend(cls: Type[ForecastBackend]) -> Type[ForecastBackend]:
    """Class decorator: register a backend under its ``name`` attribute."""
    if not getattr(cls, "name", None) or cls.name == "abstract":
        raise ValueError(f"backend class {cls.__name__} needs a name attribute")
    if _REGISTRY.get(cls.name) not in (None, cls):
        raise ValueError(f"backend {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def get_backend(
    name: str,
    config: Optional[ProphetConfig] = None,
    solver_config: Optional[SolverConfig] = None,
    **kwargs,
) -> ForecastBackend:
    """Instantiate a registered backend by name."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown backend {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](
        config=config or ProphetConfig(),
        solver_config=solver_config or SolverConfig(),
        **kwargs,
    )


#: Where resilient fits degrade to when the card path's retry budget is
#: exhausted: the per-series scipy oracle — slow, but it has no device
#: runtime and no lockstep batch to poison, so it finishes runs the
#: batched path cannot.
DEGRADED_BACKEND = "cpu"


def degraded_backend(
    config: Optional[ProphetConfig] = None,
    solver_config: Optional[SolverConfig] = None,
    **kwargs,
) -> ForecastBackend:
    """The graceful-degradation backend (see ``DEGRADED_BACKEND``): the
    which-backend-degrades-to-what decision sits with the registry;
    ``orchestrate.fit_resilient`` calls this after exhausting the card
    path, with a loud ``ResilienceWarning``."""
    return get_backend(DEGRADED_BACKEND, config, solver_config, **kwargs)


def list_backends():
    _ensure_builtins()
    return sorted(_REGISTRY)


def _ensure_builtins():
    # Imported lazily to avoid a circular import at package-import time.
    from tsspark_tpu_torch.backends import cpu, cuda  # noqa: F401
