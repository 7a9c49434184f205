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

"""Input pipeline: length-bucketed batching and device prefetch, PyTorch
port.

Counterpart of ``last_torch_tpu/data.py``:

* ``bucket_batches`` groups examples into a fixed grid of (max_frames,
  max_labels) buckets and emits padded batches of static shapes: the number
  of distinct shapes is bounded by ``len(frame_buckets) *
  len(label_buckets)``, and padding waste by the bucket granularity rather
  than the corpus maximum. The same numpy code as the JAX package's.
* ``prefetch_to_device`` stages upcoming batches on the card from a
  background thread while the current step computes: numpy arrays are
  pinned and copied with ``non_blocking`` on a side CUDA stream, and the
  consumer's stream waits on an event recorded after the copies before it
  touches a batch.

Batches are dicts with the trainer's contract: ``frames`` [B, T, F]
float32, ``num_frames`` [B] int32, ``labels`` [B, U] int32 (1-based,
0-padded), ``num_labels`` [B] int32, plus ``valid`` [B] bool when
``pad_final`` emits a partial batch (feed it to
``models.metrics.update_error_rate``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _bucket_for(value: int, boundaries: Sequence[int]) -> Optional[int]:
  """Smallest boundary >= value, or None if value exceeds them all."""
  for b in boundaries:
    if value <= b:
      return b
  return None


def bucket_batches(examples: Iterable[tuple[np.ndarray, np.ndarray]],
                   batch_size: int,
                   frame_buckets: Sequence[int],
                   label_buckets: Sequence[int],
                   pad_final: bool = False,
                   drop_overlong: bool = True) -> Iterator[dict]:
  """Groups (frames, labels) examples into static-shaped padded batches.

  Args:
    examples: Iterable of (frames [t, feature] float, labels [u] int,
      1-based) numpy pairs.
    batch_size: Sequences per emitted batch (every batch has exactly this
      leading dimension; partial final buckets are padded when
      ``pad_final`` and dropped otherwise).
    frame_buckets: Ascending frame-count boundaries, e.g. (400, 800, 1600).
    label_buckets: Ascending label-count boundaries.
    pad_final: Emit leftover examples at iterator end as batches padded
      with all-zero rows and ``valid=False`` entries.
    drop_overlong: Silently skip examples exceeding the largest bucket;
      when False, raise ValueError instead.

  Yields:
    Batch dicts (see module docstring). All arrays are numpy; shapes are
    determined solely by (bucket, batch_size), never by the data.
  """
  frame_buckets = sorted(frame_buckets)
  label_buckets = sorted(label_buckets)
  pending: dict[tuple[int, int], list] = {}
  feature_size = None

  def emit(key, items):
    nonlocal feature_size
    t_max, u_max = key
    n = len(items)
    frames = np.zeros((batch_size, t_max, feature_size), np.float32)
    num_frames = np.zeros((batch_size,), np.int32)
    labels = np.zeros((batch_size, max(u_max, 1)), np.int32)
    num_labels = np.zeros((batch_size,), np.int32)
    valid = np.zeros((batch_size,), bool)
    for i, (f, l) in enumerate(items):
      frames[i, :len(f)] = f
      num_frames[i] = len(f)
      labels[i, :len(l)] = l
      num_labels[i] = len(l)
      valid[i] = True
    batch = {'frames': frames, 'num_frames': num_frames, 'labels': labels,
             'num_labels': num_labels}
    if n < batch_size:
      batch['valid'] = valid
    return batch

  for frames, labels in examples:
    frames = np.asarray(frames)
    labels = np.asarray(labels)
    if feature_size is None:
      feature_size = frames.shape[-1]
    tb = _bucket_for(frames.shape[0], frame_buckets)
    ub = _bucket_for(labels.shape[0], label_buckets)
    if tb is None or ub is None:
      if drop_overlong:
        continue
      raise ValueError(
          f'example with {frames.shape[0]} frames / {labels.shape[0]} '
          f'labels exceeds the largest bucket '
          f'({frame_buckets[-1]}, {label_buckets[-1]})')
    key = (tb, ub)
    items = pending.setdefault(key, [])
    items.append((frames, labels))
    if len(items) == batch_size:
      yield emit(key, items)
      pending[key] = []

  if pad_final:
    for key, items in sorted(pending.items()):
      if items:
        yield emit(key, items)
def to_device(batch: dict, device) -> dict:
  """Each numpy array or tensor value of ``batch`` on ``device``; to a CUDA
  device from pinned host memory, copied without blocking the host (on the
  current stream, which orders every later use). Other values pass
  through."""
  device = torch.device(device)

  def move(v):
    if isinstance(v, np.ndarray):
      v = torch.from_numpy(np.ascontiguousarray(v))
    if not isinstance(v, torch.Tensor):
      return v
    if device.type == 'cuda' and v.device.type == 'cpu':
      return v.pin_memory().to(device, non_blocking=True)
    return v.to(device)

  return {k: move(v) for k, v in batch.items()}


def prefetch_to_device(batches: Iterable[dict],
                       size: int = 2,
                       device='cuda',
                       place: Optional[Callable[[dict], dict]] = None
                       ) -> Iterator[dict]:
  """Stages upcoming batches on the device from a background thread.

  Args:
    batches: Iterator of numpy (or host tensor) batch dicts.
    size: Number of batches staged ahead of the consumer.
    device: Target device: the card ('cuda') unless the caller asks for
      'cpu'.
    place: Optional ``batch -> device batch`` in place of ``to_device``
      (e.g. a data rank's rows, ``parallel.sharding.shard_batch``, then
      ``to_device``). On a CUDA device it runs on the side stream.

  Yields:
    The same batches with tensor values resident on the device, safe to use
    on the consumer's current stream. An exception of the source or of
    ``place`` is raised to the consumer after the batches staged before
    it. Closing the generator early stops the thread and drops the staged
    batches.
  """
  device = torch.device(device)
  on_card = device.type == 'cuda'
  if place is None:
    place = lambda b: to_device(b, device)
  copy_stream = torch.cuda.Stream(device) if on_card else None
  q: queue.Queue = queue.Queue(maxsize=size)
  stop = object()
  cancelled = threading.Event()
  error: list[BaseException] = []

  def put(item) -> bool:
    """Enqueues unless the consumer has gone away; returns False then."""
    while not cancelled.is_set():
      try:
        q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def stage(batch):
    """(device batch, event after its copies or None)."""
    if not on_card:
      return place(batch), None
    with torch.cuda.device(device), torch.cuda.stream(copy_stream):
      staged = place(batch)
      event = torch.cuda.Event()
      event.record(copy_stream)
    return staged, event

  def producer():
    try:
      for b in batches:
        if not put(stage(b)):
          return
    except BaseException as e:  # surfaced to the consumer below
      error.append(e)
    finally:
      put(stop)

  thread = threading.Thread(target=producer, daemon=True)
  thread.start()
  try:
    while True:
      item = q.get()
      if item is stop:
        if error:
          raise error[0]
        return
      staged, event = item
      if event is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        # The copies' memory belongs to the side stream's pool: tell the
        # allocator the consumer's stream uses it too.
        for leaf in pytree.tree_leaves(staged):
          if isinstance(leaf, torch.Tensor) and leaf.device.type == 'cuda':
            leaf.record_stream(consumer)
      yield staged
  finally:
    # The consumer stopped early (generator closed, exception): release the
    # producer and drop the staged batches. A put already in flight (0.1 s
    # poll) can land after one drain: drain, wait for the producer to exit,
    # then drain what it enqueued in between.
    cancelled.set()
    for _ in range(25):  # bounded: a source blocked in IO stays daemon
      try:
        while True:
          q.get_nowait()
      except queue.Empty:
        pass
      thread.join(timeout=0.2)
      if not thread.is_alive():
        break
    try:
      while True:
        q.get_nowait()
    except queue.Empty:
      pass
    # Close the source generator only once the producer has exited: close()
    # while another thread executes it raises ValueError('generator already
    # executing') and would mask the consumer's exception.
    if not thread.is_alive():
      close = getattr(batches, 'close', None)
      if close is not None:
        close()
