"""Typed allocation-scheme registry (counterpart of ``repro/core/schemes.py``).

Every load-allocation scheme is a frozen dataclass implementing
``AllocationScheme``: it carries its own typed parameters, knows its
``LatencyModel``, produces ``AllocationPlan``s and owns its Monte-Carlo
semantics. Schemes are registered by name:

    scheme = make_scheme("uniform_n", n=738)   # -> UniformN(n=738.0)
    plan = scheme.allocate(cluster, k)

``make_scheme`` rejects parameters a scheme's factory does not declare.
The port registers the reference's eleven names: ``optimal``,
``optimal_per_row``, ``uniform_n``, ``uniform_r`` (and its alias
``uniform_r_group_code``), ``reisizadeh``, ``uncoded``, ``grad_coding``,
``grad_coding_per_row``, ``comm_aware`` and ``comm_uniform``.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Mapping

import torch

from repro_torch.core import allocation, simulator
from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.runtime_model import (
    ClusterSpec,
    LatencyModel,
    resolve_latency_model,
)
from repro_torch.obs.metrics import REGISTRY as _METRICS

#: allocate() memo: (scheme, cluster, k) -> plan. Schemes and ClusterSpec
#: are frozen dataclasses, so equality covers every input of the solve.
_ALLOC_CACHE: dict = {}
_ALLOC_CACHE_CAP = 512
#: memo hits and misses since the last clear, in the process-global
#: metrics registry (the memo is module state with no run to hang a
#: registry on); the adaptive controller's ``alloc_cache_hit`` event reads
#: them and a training run's final ``metrics_snapshot`` reports them
_ALLOC_HITS = _METRICS.counter("alloc_cache_hits")
_ALLOC_MISSES = _METRICS.counter("alloc_cache_misses")


def allocate_cache_clear() -> None:
    """Drop all memoized allocations and zero the hit/miss counts."""
    _ALLOC_CACHE.clear()
    _ALLOC_HITS.reset()
    _ALLOC_MISSES.reset()


def allocate_cache_info() -> dict:
    """Memo stats: entries, cap, hits and misses."""
    return {"size": len(_ALLOC_CACHE), "cap": _ALLOC_CACHE_CAP,
            "hits": _ALLOC_HITS.value, "misses": _ALLOC_MISSES.value}


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
            _ALLOC_MISSES.inc()
            plan = self._allocate(cluster, k)
            if len(_ALLOC_CACHE) >= _ALLOC_CACHE_CAP:
                _ALLOC_CACHE.pop(next(iter(_ALLOC_CACHE)))
            _ALLOC_CACHE[cache_key] = plan
        else:
            _ALLOC_HITS.inc()
        return dataclasses.replace(
            plan, loads=plan.loads.copy(), loads_int=plan.loads_int.copy(),
            r=plan.r.copy(), scheme_obj=self, scheme=self.tag,
        )

    def replan(self, new_cluster: ClusterSpec, k: int) -> AllocationPlan:
        """Closed-form re-plan on a new membership, params preserved."""
        return self.allocate(new_cluster, k)

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

    def lower_bound(self, cluster: ClusterSpec, k: int) -> float:
        """The scheme's analytic expected latency (NaN when unknown)."""
        return float(self.allocate(cluster, k).t_star)


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
class UniformR(AllocationScheme):
    """Section III-D-2 / Theorem 4: the fixed-r group code of [33]."""

    name = "uniform_r"
    r: int = 0

    def __post_init__(self):
        if not self.r > 0:
            raise ValueError(
                f"UniformR needs the completion count r > 0, got r={self.r!r}"
            )

    @property
    def tag(self) -> str:
        return "uniform_r_group_code"

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.uniform_given_r(cluster, k, self.r)

    def simulate(self, generator, cluster, plan, num_trials=10_000, *,
                 model=None, use_integer_loads=False) -> torch.Tensor:
        """Group-code semantics: the max over groups of the r_j-th finisher."""
        loads = plan.loads_int if use_integer_loads else plan.loads
        return simulator.simulate_group_code(
            generator, cluster, float(loads[0]), plan.r, plan.k, num_trials,
            model=model or self.latency_model,
        )


@dataclasses.dataclass(frozen=True)
class Reisizadeh(AllocationScheme):
    """Appendix D: the heterogeneous allocation of [32] (per-row model)."""

    name = "reisizadeh"

    @property
    def latency_model(self) -> LatencyModel:
        return LatencyModel.MODEL_30

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.reisizadeh_allocation(cluster, k)


@dataclasses.dataclass(frozen=True)
class Uncoded(AllocationScheme):
    """Uncoded baseline: n = k uniform split, wait for every worker."""

    name = "uncoded"

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.uncoded(cluster, k)


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


@dataclasses.dataclass(frozen=True)
class _CommDelayScheme(AllocationScheme):
    """Shared CommDelay behaviour: transfer-cost params + comm simulation.

    ``upload``/``download`` are per-round transfer costs, divided by each
    group's ``ClusterSpec`` bandwidth to form the comm terms
    (``runtime_model.comm_terms``); infinite bandwidths make both vanish.
    """

    upload: float = 1.0
    download: float = 1.0

    def __post_init__(self):
        if self.upload < 0 or self.download < 0:
            raise ValueError(
                f"{type(self).__name__} transfer costs must be >= 0, got "
                f"upload={self.upload!r}, download={self.download!r}"
            )

    @property
    def latency_model(self) -> LatencyModel:
        return LatencyModel.COMM_DELAY

    def simulate(self, generator, cluster, plan, num_trials=10_000, *,
                 model=None, use_integer_loads=False) -> torch.Tensor:
        """Threshold decoding with the transfer terms; an explicit other
        ``model`` evaluates the plan comm-blind."""
        loads = plan.loads_int if use_integer_loads else plan.loads
        if model is not None and model is not LatencyModel.COMM_DELAY:
            return simulator.simulate_threshold(
                generator, cluster, loads, plan.k, num_trials, model=model
            )
        return simulator.simulate_comm_threshold(
            generator, cluster, loads, plan.k, num_trials,
            upload=self.upload, download=self.download,
        )


@dataclasses.dataclass(frozen=True)
class CommAware(_CommDelayScheme):
    """Communication-delay-aware optimum (Sun et al., arXiv:2109.11246).

    The Lambert-W inner problem at comm-shifted alphas, the outer
    deadline equation by bisection; groups whose transfer shift exceeds
    the deadline get zero load. With every transfer term zero the plan is
    ``Optimal``'s.
    """

    name = "comm_aware"

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.comm_aware_allocation(
            cluster, k, upload=self.upload, download=self.download
        )


@dataclasses.dataclass(frozen=True)
class CommUniform(_CommDelayScheme):
    """Uniform-split baseline under the CommDelay model.

    ``n`` defaults to the comm-aware optimum's code size: the same
    redundancy split uniformly over every worker, slow links included.
    """

    name = "comm_uniform"

    n: float | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.n is not None and not self.n > 0:
            raise ValueError(
                f"CommUniform needs the total coded rows n > 0, got n={self.n!r}"
            )

    def _allocate(self, cluster: ClusterSpec, k: int) -> AllocationPlan:
        return allocation.comm_uniform_allocation(
            cluster, k, n=self.n, upload=self.upload, download=self.download
        )


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


def scheme_params(name: str) -> tuple[str, ...]:
    """The keyword parameters a registered scheme accepts (sorted)."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {', '.join(scheme_names())}"
        )
    return tuple(sorted(_REGISTRY[name].params))


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


def _make_uniform_r(*, r=None):
    if r is None:
        raise ValueError("scheme 'uniform_r' requires the completion count r")
    return UniformR(r=int(r))


def _costs(**given) -> dict:
    """The provided (not None) scheme parameters, as floats."""
    return {key: float(v) for key, v in given.items() if v is not None}


def _make_comm_aware(*, upload=None, download=None):
    return CommAware(**_costs(upload=upload, download=download))


def _make_comm_uniform(*, n=None, upload=None, download=None):
    return CommUniform(**_costs(n=n, upload=upload, download=download))


def _make_grad_coding(*, per_row=None, model=None):
    return GradCoding(model=resolve_latency_model(model, per_row))


def _make_grad_coding_per_row(*, per_row=None, model=None):
    return GradCoding(model=_model_30("grad_coding", per_row, model))


register_scheme("optimal", _make_optimal)
register_scheme("optimal_per_row", _make_optimal_per_row)
register_scheme("uniform_n", _make_uniform_n)
register_scheme("grad_coding", _make_grad_coding)
register_scheme("grad_coding_per_row", _make_grad_coding_per_row)
register_scheme("uniform_r", _make_uniform_r)
register_scheme("uniform_r_group_code", _make_uniform_r)
register_scheme("reisizadeh", lambda: Reisizadeh())
register_scheme("uncoded", lambda: Uncoded())
register_scheme("comm_aware", _make_comm_aware)
register_scheme("comm_uniform", _make_comm_uniform)


def scheme_for_plan(plan) -> AllocationScheme:
    """The scheme object behind a plan (Allocation- or DeploymentPlan).

    Registry plans carry their scheme object; otherwise the scheme is
    rebuilt from the name tag and the plan's own fields: ``n`` for
    ``uniform_n`` and ``comm_uniform`` (whose transfer costs are not on
    the plan and take their defaults), ``r = k / load`` for the group code.
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
    loads = getattr(plan, "loads", None)
    if loads is None:
        loads = plan.loads_per_worker  # a DeploymentPlan without its allocation
    if tag in ("optimal", "optimal_per_row"):
        return Optimal(model=LatencyModel.from_per_row(tag == "optimal_per_row"))
    if tag == "uniform_n":
        return UniformN(n=float(plan.n))
    if tag in ("uniform_r", "uniform_r_group_code"):
        return UniformR(r=int(round(plan.k / float(loads[0]))))
    if tag == "comm_uniform":
        return CommUniform(n=float(plan.n))
    return make_scheme(tag)


#: each registered scheme's parameters, for a CLI's help
SCHEME_PARAM_DOC: Mapping[str, str] = {
    "optimal": "model: LatencyModel (default MODEL_1)",
    "grad_coding": "model: LatencyModel (default MODEL_1); "
                   "k = gradient partitions of the global batch",
    "uniform_n": "n: total coded rows (float > 0)",
    "uniform_r": "r: completion count (int in (0, N))",
    "reisizadeh": "(no params; per-row model)",
    "uncoded": "(no params)",
    "comm_aware": "upload, download: transfer costs >= 0 "
                  "(divided by ClusterSpec group bandwidths)",
    "comm_uniform": "n: code size (default: comm-aware n*); upload, download",
}
