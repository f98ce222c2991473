"""Piecewise rational-quadratic spline flows (Durkan et al., Neural Spline
Flows), full-lattice form (port of ``vits_tpu/ops/spline.py``).

Everything is computed on the whole lattice and combined with
``torch.where``, as in the JAX version; the bin search is the same
compare-and-count, so both packages pick the same bin for the same input.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor, eps: float = 1e-6):
    """Index of the bin containing each input."""
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    idx = torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1
    return idx.clamp(0, bin_locations.shape[-1] - 2)


def _knots(unnormalized, lo, hi, min_size):
    """Softmax bin sizes -> (cumulative knots with K+1 entries, sizes)."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1 - min_size * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum[..., 0] = lo
    cum[..., -1] = hi
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    left=0.0,
    right=1.0,
    bottom=0.0,
    top=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Monotonic RQ spline on [left, right] -> [bottom, top]; inputs inside
    the domain. Returns (outputs, logabsdet)."""
    cumwidths, widths = _knots(unnormalized_widths, left, right, min_bin_width)
    cumheights, heights = _knots(unnormalized_heights, bottom, top, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)[..., None]

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives)
    input_derivatives_p1 = take(derivatives[..., 1:])
    input_heights = take(heights)
    slope_sum = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        a = (inputs - input_cumheights) * slope_sum + input_heights * (
            input_delta - input_derivatives
        )
        b = input_heights * input_derivatives - (inputs - input_cumheights) * slope_sum
        c = -input_delta * (inputs - input_cumheights)
        discriminant = b**2 - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(torch.clamp(discriminant, min=0.0)))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + slope_sum * theta_one_minus_theta
        derivative_numerator = input_delta**2 * (
            input_derivatives_p1 * root**2
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2
        )
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
        return outputs, -logabsdet

    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (
        input_delta * theta**2 + input_derivatives * theta_one_minus_theta
    )
    denominator = input_delta + slope_sum * theta_one_minus_theta
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta**2 * (
        input_derivatives_p1 * theta**2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """Spline inside [-tail_bound, tail_bound], identity (linear tails) outside."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - min_derivative))
    ud = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    spl_out, spl_logdet = rational_quadratic_spline(
        inputs.clamp(-tail_bound, tail_bound),
        unnormalized_widths,
        unnormalized_heights,
        ud,
        inverse=inverse,
        left=-tail_bound,
        right=tail_bound,
        bottom=-tail_bound,
        top=tail_bound,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height,
        min_derivative=min_derivative,
    )
    outputs = torch.where(inside, spl_out, inputs)
    logabsdet = torch.where(inside, spl_logdet, torch.zeros_like(spl_logdet))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    tails=None,
    tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    kwargs = dict(
        inverse=inverse,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height,
        min_derivative=min_derivative,
    )
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, **kwargs,
        )
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        tail_bound=tail_bound, **kwargs,
    )
