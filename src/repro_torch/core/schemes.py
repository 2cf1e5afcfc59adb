"""Typed allocation-scheme registry (counterpart of ``repro/core/schemes.py``).

Every load-allocation scheme is a frozen dataclass implementing
``AllocationScheme``: it carries its own typed parameters, knows its
``LatencyModel``, produces ``AllocationPlan``s and owns its Monte-Carlo
semantics. Schemes are registered by name:

    scheme = make_scheme("uniform_n", n=738)   # -> UniformN(n=738.0)
    plan = scheme.allocate(cluster, k)

``make_scheme`` rejects parameters a scheme's factory does not declare.
This port registers ``optimal``, ``optimal_per_row``, ``uniform_n``,
``grad_coding`` and ``grad_coding_per_row``.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch

from repro_torch.core import allocation, simulator
from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.runtime_model import (
    ClusterSpec,
    LatencyModel,
    resolve_latency_model,
)

#: allocate() memo: (scheme, cluster, k) -> plan. Schemes and ClusterSpec
#: are frozen dataclasses, so equality covers every input of the solve.
_ALLOC_CACHE: dict = {}
_ALLOC_CACHE_CAP = 512


def allocate_cache_clear() -> None:
    """Drop all memoized allocations."""
    _ALLOC_CACHE.clear()


@dataclasses.dataclass(frozen=True)
class AllocationScheme:
    """Base class for typed, registered load-allocation schemes."""

    #: registry name (subclasses override)
    name = "base"

    @property
    def latency_model(self) -> LatencyModel:
        """The runtime model this scheme's math is defined under."""
        return LatencyModel.MODEL_1

    @property
    def tag(self) -> str:
        """Name tag stored on plans."""
        return self.name

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        raise NotImplementedError

    def allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        """Per-group real/integer loads for ``cluster``; attaches self.

        Memoized on (scheme, cluster, k), FIFO-evicted at the cap; every
        return carries fresh array copies so callers cannot corrupt the
        cached solve.
        """
        cache_key = (self, cluster, int(k))
        plan = _ALLOC_CACHE.get(cache_key)
        if plan is None:
            plan = self._allocate(cluster, k)
            if len(_ALLOC_CACHE) >= _ALLOC_CACHE_CAP:
                _ALLOC_CACHE.pop(next(iter(_ALLOC_CACHE)))
            _ALLOC_CACHE[cache_key] = plan
        return dataclasses.replace(
            plan, loads=plan.loads.copy(), loads_int=plan.loads_int.copy(),
            r=plan.r.copy(), scheme_obj=self, scheme=self.tag,
        )

    def simulate(
        self,
        generator: torch.Generator,
        cluster: ClusterSpec,
        plan: AllocationPlan,
        num_trials: int = 10_000,
        *,
        model: LatencyModel | None = None,
        use_integer_loads: bool = False,
    ) -> torch.Tensor:
        """Monte-Carlo latency samples (threshold decoding)."""
        loads = plan.loads_int if use_integer_loads else plan.loads
        return simulator.simulate_threshold(
            generator, cluster, loads, plan.k, num_trials,
            model=model or self.latency_model,
        )

    def expected_latency(self, generator, cluster, plan, num_trials=10_000,
                         **kwargs) -> float:
        """Mean of ``simulate``."""
        return float(torch.mean(
            self.simulate(generator, cluster, plan, num_trials, **kwargs)
        ))


@dataclasses.dataclass(frozen=True)
class Optimal(AllocationScheme):
    """The paper's optimum: Theorem 2 (MODEL_1) / Corollary 2 (MODEL_30)."""

    name = "optimal"
    model: LatencyModel = LatencyModel.MODEL_1

    @property
    def latency_model(self) -> LatencyModel:
        return self.model

    @property
    def tag(self) -> str:
        return "optimal_per_row" if self.model.per_row else "optimal"

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.optimal_allocation(cluster, k, model=self.model)


@dataclasses.dataclass(frozen=True)
class UniformN(AllocationScheme):
    """Section III-D-1: uniform split of a fixed-size (n, k) code."""

    name = "uniform_n"
    n: float = 0.0

    def __post_init__(self):
        if not self.n > 0:
            raise ValueError(
                f"UniformN needs the total coded rows n > 0, got n={self.n!r}"
            )

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.uniform_given_n(cluster, k, self.n)


@dataclasses.dataclass(frozen=True)
class GradCoding(AllocationScheme):
    """Heterogeneity-aware gradient coding (Wang et al., arXiv:1901.09339).

    ``k`` is the number of gradient partitions of the global batch; loads
    are coded partition-gradients per worker (Theorem 2 clamped to k).
    Threshold decoding, so simulation and deadline come from the base.
    """

    name = "grad_coding"
    model: LatencyModel = LatencyModel.MODEL_1

    @property
    def latency_model(self) -> LatencyModel:
        return self.model

    @property
    def tag(self) -> str:
        return "grad_coding_per_row" if self.model.per_row else "grad_coding"

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.gradient_coding_allocation(cluster, k, model=self.model)


# --------------------------------------------------------------- registry
SchemeFactory = Callable[..., AllocationScheme]


@dataclasses.dataclass(frozen=True)
class _Registration:
    factory: SchemeFactory
    params: frozenset  # keyword params this factory accepts


_REGISTRY: dict[str, _Registration] = {}


def _factory_params(factory: SchemeFactory) -> frozenset:
    """Named keyword parameters a factory declares (``**kw`` widens nothing)."""
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):
        return frozenset()
    return frozenset(
        p.name for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    )


def register_scheme(name: str, factory: SchemeFactory, *, params=None) -> None:
    """Register a scheme factory under a lookup name."""
    if name in _REGISTRY:
        raise ValueError(f"scheme {name!r} already registered")
    accepted = _factory_params(factory) if params is None else frozenset(params)
    _REGISTRY[name] = _Registration(factory, accepted)


def scheme_names() -> tuple[str, ...]:
    """All registered lookup names."""
    return tuple(sorted(_REGISTRY))


def make_scheme(
    name: str,
    *,
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    n: float | None = None,
    r: int | None = None,
    **params,
) -> AllocationScheme:
    """Resolve a registered scheme name + params to a typed scheme object.

    ``None`` means "not provided"; any provided parameter the factory
    does not declare raises.
    """
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {', '.join(scheme_names())}"
        )
    reg = _REGISTRY[name]
    provided = {"per_row": per_row, "model": model, "n": n, "r": r, **params}
    provided = {key: v for key, v in provided.items() if v is not None}
    unknown = sorted(set(provided) - reg.params)
    if unknown:
        accepted = ", ".join(sorted(reg.params)) or "(none)"
        raise ValueError(
            f"scheme {name!r} does not accept parameter(s) "
            f"{', '.join(unknown)}; accepted: {accepted}"
        )
    return reg.factory(**provided)


def _make_optimal(*, per_row=None, model=None):
    return Optimal(model=resolve_latency_model(model, per_row))


def _model_30(base: str, per_row, model) -> LatencyModel:
    """The per-row model of a ``<base>_per_row`` scheme; any other raises."""
    m = resolve_latency_model(model, per_row, default=LatencyModel.MODEL_30)
    if m is not LatencyModel.MODEL_30:
        raise ValueError(
            f"scheme '{base}_per_row' is fixed to MODEL_30; use '{base}' "
            "with model=MODEL_1 instead"
        )
    return m


def _make_optimal_per_row(*, per_row=None, model=None):
    return Optimal(model=_model_30("optimal", per_row, model))


def _make_uniform_n(*, n=None):
    if n is None:
        raise ValueError("scheme 'uniform_n' requires the code size n")
    return UniformN(n=float(n))


def _make_grad_coding(*, per_row=None, model=None):
    return GradCoding(model=resolve_latency_model(model, per_row))


def _make_grad_coding_per_row(*, per_row=None, model=None):
    return GradCoding(model=_model_30("grad_coding", per_row, model))


register_scheme("optimal", _make_optimal)
register_scheme("optimal_per_row", _make_optimal_per_row)
register_scheme("uniform_n", _make_uniform_n)
register_scheme("grad_coding", _make_grad_coding)
register_scheme("grad_coding_per_row", _make_grad_coding_per_row)


def scheme_for_plan(plan) -> AllocationScheme:
    """The scheme object behind a plan (Allocation- or DeploymentPlan).

    Registry plans carry their scheme object; otherwise the scheme is
    rebuilt from the name tag (and ``n`` for ``uniform_n``).
    """
    obj = getattr(plan, "scheme_obj", None)
    if obj is not None:
        return obj
    alloc = getattr(plan, "allocation", None)
    if alloc is not None:
        if alloc.scheme_obj is not None:
            return alloc.scheme_obj
        plan = alloc
    tag = plan.scheme
    if tag in ("optimal", "optimal_per_row"):
        return Optimal(model=LatencyModel.from_per_row(tag == "optimal_per_row"))
    if tag == "uniform_n":
        return UniformN(n=float(plan.n))
    return make_scheme(tag)
