"""L-BFGS with a zoom line search, on one tensor of parameters.

Port of optax 0.2.6's ``optax.lbfgs(learning_rate)`` with its defaults,
which the JAX package's MPC_LBFGS baseline runs
(``diffphycon_tpu/baselines/mpc_jellyfish.py``): the chain of

1. ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
   (``optax/_src/transform.py``): the gradient times the two-loop inverse
   Hessian estimate from the last ``memory_size`` parameter and gradient
   differences, the identity scaled by s.y / y.y (at the first step by
   min(1, 1 / |g|));
2. the scaling by -learning_rate;
3. ``scale_by_zoom_linesearch(max_linesearch_steps=20,
   initial_guess_strategy="one")`` (``optax/_src/linesearch.py``): a step
   size along that direction meeting the sufficient-decrease and
   small-curvature conditions (Nocedal and Wright, Algorithms 3.5 and 3.6,
   with Hager and Zhang's approximate decrease), tried from 1.

``init(params)`` and ``update(grad, state, params, value, value_fn,
learning_rate)`` keep optax's contract: ``params + updates`` is the next
iterate, and ``value_fn(x)`` returns the objective as a scalar tensor,
which the line search differentiates itself. Each evaluation's autograd
graph is freed before the next one starts. The vector arithmetic stays on the parameters'
device; the line search's branches are decisions on float32 scalars on the
host, in optax's order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
# scale_by_zoom_linesearch's defaults
_TOL = 0.0
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5  # stepsize_precision

_f32 = np.float32
_INF = _f32(np.inf)


def value_and_grad(value_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor):
    """(value_fn(x) as a float32 host scalar, its gradient). The graph is
    freed when the gradient is taken."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        value = value_fn(x)
        (grad,) = torch.autograd.grad(value, x)
    return _f32(value.item()), grad


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


@dataclasses.dataclass
class LBFGSState:
    count: int
    params: torch.Tensor        # the previous iterate
    updates: torch.Tensor       # the previous gradient
    diff_params: torch.Tensor   # (MEMORY_SIZE, *shape)
    diff_updates: torch.Tensor  # (MEMORY_SIZE, *shape)
    weights: torch.Tensor       # (MEMORY_SIZE,) 1 / (dg . dw)
    stepsize: np.float32 = _f32(1.0)  # the line search's last accepted step size
    num_linesearch_steps: int = 0     # its trials


def init(params: torch.Tensor) -> LBFGSState:
    z = torch.zeros_like(params)
    mem = torch.zeros((MEMORY_SIZE, *params.shape), dtype=params.dtype, device=params.device)
    return LBFGSState(count=0, params=z, updates=z, diff_params=mem, diff_updates=mem.clone(),
                      weights=torch.zeros(MEMORY_SIZE, dtype=params.dtype,
                                          device=params.device))


def _precondition(updates, diff_params, diff_updates, rhos, identity_scale, memory_idx):
    """The two-loop recursion (Nocedal and Wright, Algorithm 7.4), oldest
    memory slot first in the second loop."""
    m = rhos.shape[0]
    indices = [(memory_idx + i) % m for i in range(m)]
    vec, alphas = updates, {}
    for idx in reversed(indices):
        alphas[idx] = rhos[idx] * _dot(diff_params[idx], vec)
        vec = vec - alphas[idx] * diff_updates[idx]
    vec = identity_scale * vec
    for idx in indices:
        beta = rhos[idx] * _dot(diff_updates[idx], vec)
        vec = vec + (alphas[idx] - beta) * diff_params[idx]
    return vec


def _scale_by_lbfgs(grad, state: LBFGSState, params):
    """optax.scale_by_lbfgs's update: the memory updated with this step's
    differences, then the preconditioned gradient. Returns (direction, the
    memory fields of the new state)."""
    m = state.weights.shape[0]
    memory_idx, prev_idx = state.count % m, (state.count - 1) % m
    diff_params = params - state.params
    diff_updates = grad - state.updates
    vdot = _dot(diff_updates, diff_params)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    if state.count == 0:
        diff_params, diff_updates = torch.zeros_like(params), torch.zeros_like(grad)
        weight = torch.zeros_like(weight)
    dp_mem, du_mem, w_mem = (state.diff_params.clone(), state.diff_updates.clone(),
                             state.weights.clone())
    dp_mem[prev_idx], du_mem[prev_idx], w_mem[prev_idx] = diff_params, diff_updates, weight
    if state.count > 0:
        den = _dot(diff_updates, diff_updates)
        scale = torch.where(den > 0.0, _dot(diff_updates, diff_params) / den,
                            torch.ones_like(den))
    else:
        scale = torch.clamp(1.0 / grad.norm(), max=1.0)
    direction = _precondition(grad, dp_mem, du_mem, w_mem, scale, memory_idx)
    return direction, dict(count=state.count + 1, params=params, updates=grad,
                           diff_params=dp_mem, diff_updates=du_mem, weights=w_mem)


@dataclasses.dataclass
class _Zoom:
    """optax's ZoomLinesearchState, the scalars on the host: the current
    trial (stepsize, value, grad, slope), the interval's ends (low, high)
    and the cubic's third point, and the best step with sufficient
    decrease so far (safe_*)."""

    value_init: np.float32
    slope_init: np.float32
    stepsize: np.float32
    value: np.float32
    grad: torch.Tensor
    slope: np.float32
    low: np.float32
    value_low: np.float32
    slope_low: np.float32
    high: np.float32
    value_high: np.float32
    slope_high: np.float32
    cubic_ref: np.float32
    value_cubic_ref: np.float32
    safe_stepsize: np.float32
    safe_value: np.float32
    safe_grad: torch.Tensor
    count: int = 0
    decrease_error: np.float32 = _INF
    interval_found: bool = False
    done: bool = False
    failed: bool = False


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN when there is none)."""
    with np.errstate(all="ignore"):
        cc = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        x0, x1 = fb - fa - cc * db, fc - fa - cc * dc
        aa = (dc ** 2 * x0 - db ** 2 * x1) / denom
        bb = (-(dc ** 3) * x0 + db ** 3 * x1) / denom
        radical = bb * bb - _f32(3.0) * aa * cc
        return a + (-bb + np.sqrt(radical)) / (_f32(3.0) * aa)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the parabola through (a, fa), (b, fb) with
    slope fpa at a."""
    with np.errstate(all="ignore"):
        db = b - a
        bb = (fb - fa - fpa * db) / (db ** 2)
        return a - fpa / (_f32(2.0) * bb)


def _errors(stepsize, value_step, slope_step, value_init, slope_init):
    """(decrease error, curvature error), optax's definitions with the
    approximate decrease; NaN counts as infinite."""
    with np.errstate(all="ignore"):
        dec = value_step - value_init - _f32(_SLOPE_RTOL) * stepsize * slope_init
        approx = slope_step - _f32(2 * _SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init - _f32(_APPROX_DEC_RTOL) * abs(value_init)
        dec = np.minimum(np.maximum(approx, delta_values), dec)
        dec = np.maximum(dec, _f32(0.0))
        curv = np.maximum(abs(slope_step) - _f32(_CURV_RTOL) * abs(slope_init), _f32(0.0))
    return (_INF if np.isnan(dec) else _f32(dec)), (_INF if np.isnan(curv) else _f32(curv))


def _search_interval(z: _Zoom, on_line, stepsize_guess) -> None:
    """Algorithm 3.5: grow the step until an interval holding an
    acceptable step is found."""
    new = stepsize_guess if z.count == 0 else _f32(_INCREASE_FACTOR) * z.stepsize
    value, grad, slope = on_line(new)
    dec, curv = _errors(new, value, slope, z.value_init, z.slope_init)
    err = max(dec, curv)
    if dec <= _TOL:
        z.safe_stepsize, z.safe_value, z.safe_grad = new, value, grad
    set_high = dec > 0.0 or (value >= z.value and z.count > 0)
    set_low = slope >= 0.0 and not set_high
    prev = (z.stepsize, z.value, z.slope)
    if set_low:
        (z.low, z.value_low, z.slope_low), (z.high, z.value_high, z.slope_high) = \
            (new, value, slope), prev
    else:
        (z.low, z.value_low, z.slope_low), (z.high, z.value_high, z.slope_high) = \
            prev, (new, value, slope)
    z.interval_found = set_high or set_low or err <= _TOL
    z.done = err <= _TOL
    z.failed = z.count + 1 >= MAX_LINESEARCH_STEPS and not z.done
    z.cubic_ref, z.value_cubic_ref = z.low, z.value_low
    z.count += 1
    z.stepsize, z.value, z.grad, z.slope, z.decrease_error = new, value, grad, slope, dec


def _zoom_into_interval(z: _Zoom, on_line) -> None:
    """Algorithm 3.6: shrink the interval by cubic, quadratic or bisection
    steps."""
    low, high = z.low, z.high
    delta = abs(high - low)
    left, right = min(high, low), max(high, low)
    too_small = delta <= _INTERVAL_THRESHOLD
    mid_cubic = _cubicmin(low, z.value_low, z.slope_low, high, z.value_high, z.cubic_ref,
                          z.value_cubic_ref)
    mid_quad = _quadmin(low, z.value_low, z.slope_low, high, z.value_high)
    if left + _f32(0.2) * delta < mid_cubic < right - _f32(0.2) * delta:
        middle = mid_cubic
    elif left + _f32(0.1) * delta < mid_quad < right - _f32(0.1) * delta:
        middle = mid_quad
    else:
        middle = (low + high) / _f32(2.0)
    value, grad, slope = on_line(middle)
    dec, curv = _errors(middle, value, slope, z.value_init, z.slope_init)
    err = max(dec, curv)
    if dec <= _TOL and value < z.safe_value:
        z.safe_stepsize, z.safe_value, z.safe_grad = middle, value, grad
    z.done = err <= _TOL
    set_high_to_middle = dec > 0.0 or value >= z.value_low
    set_high_to_low = slope * (high - low) >= 0.0 and not set_high_to_middle
    old_low, old_high = (low, z.value_low, z.slope_low), (high, z.value_high, z.slope_high)
    new_high = old_high
    if set_high_to_middle:
        new_high = (middle, value, slope)
    if set_high_to_low:
        new_high = old_low
    new_low = old_low if set_high_to_middle else (middle, value, slope)
    if set_high_to_middle or set_high_to_low:
        z.cubic_ref, z.value_cubic_ref = old_high[0], old_high[1]
    else:
        z.cubic_ref, z.value_cubic_ref = old_low[0], old_low[1]
    (z.low, z.value_low, z.slope_low), (z.high, z.value_high, z.slope_high) = new_low, new_high
    presumably_failed = z.count + 1 >= MAX_LINESEARCH_STEPS or (
        too_small and z.safe_stepsize > 0.0)
    z.failed = presumably_failed and not z.done
    z.count += 1
    z.stepsize, z.value, z.grad, z.slope, z.decrease_error = middle, value, grad, slope, dec


def _zoom_linesearch(params, direction, value, grad, value_fn) -> _Zoom:
    """Run the line search from step 0 along ``direction``; the returned
    state's stepsize, value and grad are the accepted step's."""
    slope = _f32(_dot(direction, grad).item())

    def on_line(stepsize):
        v, g = value_and_grad(value_fn, params + float(stepsize) * direction)
        return v, g, _f32(_dot(g, direction).item())

    zero = _f32(0.0)
    z = _Zoom(value_init=value, slope_init=slope, stepsize=zero, value=value, grad=grad,
              slope=slope, low=zero, value_low=value, slope_low=slope, high=zero,
              value_high=value, slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
              safe_stepsize=zero, safe_value=value, safe_grad=grad)
    while not (z.done or z.failed):
        if z.interval_found:
            _zoom_into_interval(z, on_line)
        else:
            _search_interval(z, on_line, _f32(1.0))  # initial_guess_strategy="one"
        if z.failed and (z.safe_stepsize > 0.0 or np.isinf(z.decrease_error)):
            # _try_safe_step: fall back on the best step with sufficient decrease
            z.stepsize, z.value, z.grad = z.safe_stepsize, z.safe_value, z.safe_grad
    return z


def update(grad: torch.Tensor, state: LBFGSState, params: torch.Tensor, value,
           value_fn: Callable[[torch.Tensor], torch.Tensor], learning_rate: float):
    """One L-BFGS step: (updates, new state); ``params + updates`` is the
    next iterate. ``value`` and ``grad`` are the objective and its gradient
    at ``params``; ``value_fn`` is evaluated (with its gradient) at each
    line-search trial."""
    direction, memory = _scale_by_lbfgs(grad, state, params)
    direction = -learning_rate * direction
    z = _zoom_linesearch(params, direction, _f32(value), grad, value_fn)
    return float(z.stepsize) * direction, LBFGSState(**memory, stepsize=z.stepsize,
                                                     num_linesearch_steps=z.count)
