# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Semirings over tensor values, PyTorch port.

Counterpart of ``last_torch_tpu/semirings.py``: the value helpers,
``Semiring``, ``Real``, ``Log`` and ``MaxTropical``, and the tuple-valued
``Expectation`` (with ``LogLogExpectation``) and ``Cartesian``. A semiring
value is a pytree of identically shaped tensors: one tensor for the first
three, a pair for the tuple semirings, whose ``zeros`` / ``ones`` take a
pair of dtypes and one device.

Gradient contracts (the JAX package's, there as ``jax.custom_vjp``, here as
``torch.autograd.Function``):

* ``Log.plus`` / ``Log.sum``: all operands ``-inf`` give ``-inf`` and zero
  gradients (plain ``torch.logaddexp`` gives NaN there); ``-inf`` operands
  mixed with finite ones get zero gradient; ``+inf`` operands give ``+inf``
  and NaN gradients for the ``+inf`` operands, zero for the others.
* ``MaxTropical.plus`` / ``MaxTropical.sum``: the gradient is one-hot on
  exactly one argmax element, the first, even on ties.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence
from typing import Any, Generic, Optional, TypeVar

import torch
from torch.utils import _pytree as pytree

PyTree = Any
T = TypeVar('T')
S = TypeVar('S')


def value_shape(x: PyTree) -> tuple[int, ...]:
  """The shape shared by every leaf of a semiring value.

  Raises:
    ValueError: If ``x`` is empty or its leaves disagree on shape.
  """
  leaves = pytree.tree_leaves(x)
  if not leaves:
    raise ValueError(
        f'No common shape can be derived for an empty PyTree: {x!r}')
  shapes = [tuple(leaf.shape) for leaf in leaves]
  for s in shapes[1:]:
    if s != shapes[0]:
      raise ValueError(
          'A semiring value must consist of ndarrays of a common shape. '
          f'Got inconsistent shapes {shapes[0]} vs {s} for PyTree: {x!r}')
  return shapes[0]


def value_dtype(x: PyTree) -> PyTree:
  """The dtypes of a semiring value (same structure as x)."""
  return pytree.tree_map(lambda leaf: leaf.dtype, x)


def where(cond: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
  """Elementwise select between two semiring values (pytree-aware)."""
  return pytree.tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def stack(values: Sequence[PyTree], axis: int = 0) -> PyTree:
  """Stacks a sequence of semiring values along a new axis, leaf-wise."""
  return pytree.tree_map(lambda *leaves: torch.stack(leaves, dim=axis),
                         *values)


def _check_axis(shape, axis) -> int:
  if not isinstance(axis, int):
    raise ValueError(f'Only int axis is supported, got axis={axis!r}')
  ndim = len(shape)
  if not -ndim <= axis < ndim:
    raise ValueError(f'Invalid reduction axis={axis!r} for input shape '
                     f'{tuple(shape)}')
  return axis if axis >= 0 else axis + ndim


class Semiring(Generic[T]):
  """Base Semiring interface (see the JAX package's ``Semiring``).

  ``zeros`` and ``ones`` take the device beside the dtype: tensors carry
  one, JAX arrays did not.
  """

  def zeros(self, shape, dtype=None, device=None) -> T:
    raise NotImplementedError

  def ones(self, shape, dtype=None, device=None) -> T:
    raise NotImplementedError

  def times(self, a: T, b: T) -> T:
    raise NotImplementedError

  def plus(self, a: T, b: T) -> T:
    raise NotImplementedError

  def prod(self, a: T, axis: int) -> T:
    raise NotImplementedError

  def sum(self, a: T, axis: int) -> T:
    raise NotImplementedError


def _full(shape, value, dtype, device):
  return torch.full(tuple(shape), value, dtype=dtype or torch.float32,
                    device=device)


class _Real(Semiring[torch.Tensor]):
  """Real semiring (+, *)."""

  @staticmethod
  def zeros(shape, dtype=None, device=None):
    return _full(shape, 0.0, dtype, device)

  @staticmethod
  def ones(shape, dtype=None, device=None):
    return _full(shape, 1.0, dtype, device)

  @staticmethod
  def times(a, b):
    return a * b

  @staticmethod
  def plus(a, b):
    return a + b

  @staticmethod
  def prod(a, axis):
    return torch.prod(a, dim=_check_axis(a.shape, axis))

  @staticmethod
  def sum(a, axis):
    return torch.sum(a, dim=_check_axis(a.shape, axis))


Real = _Real()


class _LogAddExp(torch.autograd.Function):
  """logaddexp with the safe-gradient contract of the module docstring."""

  @staticmethod
  def forward(ctx, a, b):
    c = torch.maximum(a, b)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    ea = torch.exp(a - c)
    eb = torch.exp(b - c)
    z = ea + eb
    ctx.save_for_backward(ea, eb, z)
    return c + torch.log(z)

  @staticmethod
  def backward(ctx, g):
    ea, eb, z = ctx.saved_tensors
    scale = g / torch.where(z == 0, torch.ones_like(z), z)
    return scale * ea, scale * eb


class _LogSumExp(torch.autograd.Function):
  """logsumexp along one axis with the safe-gradient contract."""

  @staticmethod
  def forward(ctx, a, axis):
    c = torch.amax(a, dim=axis, keepdim=True)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    e = torch.exp(a - c)
    z = torch.sum(e, dim=axis, keepdim=True)
    ctx.axis = axis
    ctx.save_for_backward(e, z)
    return (c + torch.log(z)).squeeze(axis)

  @staticmethod
  def backward(ctx, g):
    e, z = ctx.saved_tensors
    z = torch.where(z == 0, torch.ones_like(z), z)
    return g.unsqueeze(ctx.axis) / z * e, None


class _Log(Semiring[torch.Tensor]):
  """Log semiring (logaddexp, +) with safe gradients."""

  @staticmethod
  def zeros(shape, dtype=None, device=None):
    return _full(shape, float('-inf'), dtype, device)

  @staticmethod
  def ones(shape, dtype=None, device=None):
    return _full(shape, 0.0, dtype, device)

  @staticmethod
  def times(a, b):
    return a + b

  @staticmethod
  def plus(a, b):
    return _LogAddExp.apply(*torch.broadcast_tensors(a, b))

  @staticmethod
  def prod(a, axis):
    return torch.sum(a, dim=_check_axis(a.shape, axis))

  @classmethod
  def sum(cls, a, axis):
    axis = _check_axis(a.shape, axis)
    if a.numel() > 0:
      return _LogSumExp.apply(a, axis)
    # Summing an empty axis yields semiring zeros.
    return cls.zeros(a.shape[:axis] + a.shape[axis + 1:], a.dtype, a.device)


Log = _Log()


class _Maximum(torch.autograd.Function):
  """maximum whose gradient goes to ``a`` on a tie."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a >= b)
    return torch.maximum(a, b)

  @staticmethod
  def backward(ctx, g):
    (choose_a,) = ctx.saved_tensors
    return torch.where(choose_a, g, 0.0), torch.where(choose_a, 0.0, g)


class _Max(torch.autograd.Function):
  """max along one axis whose gradient is one-hot on the first argmax."""

  @staticmethod
  def forward(ctx, a, axis):
    values, argmax = torch.max(a, dim=axis)  # first maximal index
    ctx.axis = axis
    ctx.shape = a.shape
    ctx.save_for_backward(argmax)
    return values

  @staticmethod
  def backward(ctx, g):
    (argmax,) = ctx.saved_tensors
    grad = g.new_zeros(ctx.shape)
    grad.scatter_(ctx.axis, argmax.unsqueeze(ctx.axis), g.unsqueeze(ctx.axis))
    return grad, None


class _MaxTropical(Semiring[torch.Tensor]):
  """Max-tropical semiring (max, +) with one-hot argmax gradients."""

  @staticmethod
  def zeros(shape, dtype=None, device=None):
    return _full(shape, float('-inf'), dtype, device)

  @staticmethod
  def ones(shape, dtype=None, device=None):
    return _full(shape, 0.0, dtype, device)

  @staticmethod
  def times(a, b):
    return a + b

  @staticmethod
  def plus(a, b):
    return _Maximum.apply(*torch.broadcast_tensors(a, b))

  @staticmethod
  def prod(a, axis):
    return torch.sum(a, dim=_check_axis(a.shape, axis))

  @classmethod
  def sum(cls, a, axis):
    axis = _check_axis(a.shape, axis)
    if a.numel() > 0:
      return _Max.apply(a, axis)
    return cls.zeros(a.shape[:axis] + a.shape[axis + 1:], a.dtype, a.device)


MaxTropical = _MaxTropical()


def zeros_like(semiring: Semiring, x: PyTree,
               shape: Optional[Sequence[int]] = None):
  """Semiring zeros with ``x``'s dtypes and device (and shape by default);
  ``x`` may be any semiring value, a tuple one too."""
  leaves = pytree.tree_leaves(x)
  shape = value_shape(x) if shape is None else tuple(shape)
  return semiring.zeros(shape, value_dtype(x), leaves[0].device)


def _split_dtype(dtype):
  return (None, None) if dtype is None else tuple(dtype)


@dataclasses.dataclass(frozen=True)
class Expectation(Generic[T, S], Semiring[tuple[T, S]]):
  """Eisner's expectation semiring over (weight, weighted-sum) pairs.

  Values are tuples ``(w, x)``: ``w`` carries path weight in the ``self.w``
  semiring and ``x`` accumulates the weight-scaled quantity of interest in
  ``self.x``, so that one shortest-distance pass computes a normalizer and
  an expectation together (path entropy, for one). Build values with
  ``weighted``; ``LogLogExpectation`` is the log / log instance.

  Attributes:
    w: Semiring of the weight component.
    x: Semiring of the weighted-sum component.
    w_to_x: Conversion of ``w``-semiring values into ``x``-semiring ones.
  """
  w: Semiring[T]
  x: Semiring[S]
  w_to_x: Callable[[T], S]

  def weighted(self, w: T, v: S) -> tuple[T, S]:
    # Where w is the w-semiring zero, w_to_x(w) is the x-semiring zero, and
    # the weighted value is the x-semiring zero too: v is replaced by zero
    # first, so that under Log a -inf w with a +inf v (0 * log 0) gives no
    # NaN.
    w_is_zero = w == self.w.zeros((), value_dtype(w), w.device)
    safe_v = torch.where(w_is_zero, torch.zeros_like(v), v)
    return w, self.x.times(self.w_to_x(w), safe_v)

  def zeros(self, shape, dtype=None, device=None):
    dtype_w, dtype_x = _split_dtype(dtype)
    return (self.w.zeros(shape, dtype_w, device),
            self.x.zeros(shape, dtype_x, device))

  def ones(self, shape, dtype=None, device=None):
    dtype_w, dtype_x = _split_dtype(dtype)
    return (self.w.ones(shape, dtype_w, device),
            self.x.zeros(shape, dtype_x, device))

  def times(self, a, b):
    w_a, x_a = a
    w_b, x_b = b
    w = self.w.times(w_a, w_b)
    x = self.x.plus(self.x.times(self.w_to_x(w_a), x_b),
                    self.x.times(self.w_to_x(w_b), x_a))
    return w, x

  def plus(self, a, b):
    w_a, x_a = a
    w_b, x_b = b
    return self.w.plus(w_a, w_b), self.x.plus(x_a, x_b)

  def sum(self, a, axis):
    w, x = a
    return self.w.sum(w, axis), self.x.sum(x, axis)


# Weight and weighted sum both in the Log semiring: only sums of
# non-negative values are representable.
LogLogExpectation = Expectation(w=Log, x=Log, w_to_x=lambda x: x)


@dataclasses.dataclass(frozen=True)
class Cartesian(Generic[T, S], Semiring[tuple[T, S]]):
  """Cartesian product of two semirings.

  Attributes:
    x: The first semiring.
    y: The second semiring.
  """
  x: Semiring[T]
  y: Semiring[S]

  def zeros(self, shape, dtype=None, device=None):
    dtype_x, dtype_y = _split_dtype(dtype)
    return (self.x.zeros(shape, dtype_x, device),
            self.y.zeros(shape, dtype_y, device))

  def ones(self, shape, dtype=None, device=None):
    dtype_x, dtype_y = _split_dtype(dtype)
    return (self.x.ones(shape, dtype_x, device),
            self.y.ones(shape, dtype_y, device))

  def times(self, a, b):
    a_x, a_y = a
    b_x, b_y = b
    return self.x.times(a_x, b_x), self.y.times(a_y, b_y)

  def plus(self, a, b):
    a_x, a_y = a
    b_x, b_y = b
    return self.x.plus(a_x, b_x), self.y.plus(a_y, b_y)

  def sum(self, a, axis):
    a_x, a_y = a
    return self.x.sum(a_x, axis), self.y.sum(a_y, axis)

  def prod(self, a, axis):
    a_x, a_y = a
    return self.x.prod(a_x, axis), self.y.prod(a_y, axis)


def cumulative_times(semiring: Semiring, x: PyTree, axis: int) -> PyTree:
  """Inclusive cumulative ``semiring.times`` along ``axis``.

  Hillis-Steele doubling: ceil(log2 n) steps, each one elementwise
  ``times`` of the value with itself shifted by 1, 2, 4, ... positions,
  the vacated positions filled with the semiring one. Every semiring goes
  this one way (Log and MaxTropical too), in log depth, and autograd
  differentiates it; results match a sequential product up to float
  reassociation (the JAX package's ``lax.associative_scan``).

  Args:
    semiring: The semiring, any ``times`` that is associative.
    x: A semiring value.
    axis: The axis to accumulate along.

  Returns:
    A value of ``x``'s shape whose entry i is x[0] (x) ... (x) x[i].
  """
  shape = value_shape(x)
  axis = _check_axis(shape, axis)
  n = shape[axis]
  dtypes = value_dtype(x)
  device = pytree.tree_leaves(x)[0].device
  shift = 1
  while shift < n:
    fill = semiring.ones(shape[:axis] + (shift,) + shape[axis + 1:], dtypes,
                         device)
    shifted = pytree.tree_map(
        lambda one, leaf: torch.cat([one, leaf.narrow(axis, 0, n - shift)],
                                    dim=axis), fill, x)
    x = semiring.times(shifted, x)
    shift *= 2
  return x
