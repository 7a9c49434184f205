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
``Semiring``, ``Real``, ``Log`` and ``MaxTropical``. A semiring value is a
pytree of identically shaped tensors (one tensor for these three; tuples
for the Expectation / Cartesian semirings, which come with ``weight_lift``,
ROADMAP queue 1, item 7).

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

from collections.abc import Sequence
from typing import Any, Generic, Optional, TypeVar

import torch
from torch.utils import _pytree as pytree

PyTree = Any
T = TypeVar('T')


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


def zeros_like(semiring: Semiring, x: torch.Tensor,
               shape: Optional[Sequence[int]] = None):
  """Semiring zeros with ``x``'s dtype and device (and shape by default)."""
  return semiring.zeros(x.shape if shape is None else shape, x.dtype,
                        x.device)
