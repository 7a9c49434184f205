"""The port's span recorder, ``utils/profiling.py``: the off state, span
trees and call ids, self time, spans closed by exceptions, the clocks'
anchor, and the spans of ``GNATModel.decode`` on the CPU."""

import time

import pytest
import torch

from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.utils import profiling

SMALL = dict(feature_size=6, vocab_size=7, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)

DECODE_TREE = [('gnat.decode', None), ('encoder.apply', 'gnat.decode'),
               ('lattice.cache', 'gnat.decode'),
               ('viterbi.project', 'gnat.decode'),
               ('viterbi.forward', 'gnat.decode'),
               ('viterbi.backtrace', 'gnat.decode')]


def refuse(*args, **kwargs):
  raise AssertionError('read or recorded while recording is off')


def test_span_off_is_one_noop_that_reads_nothing(monkeypatch):
  assert profiling._recording is None
  with monkeypatch.context() as patch:
    for clock in ('perf_counter_ns', 'time_ns', 'monotonic_ns',
                  'perf_counter'):
      patch.setattr(time, clock, refuse)
    patch.setattr(torch.cuda, 'Event', refuse)
    patch.setattr(torch.profiler, 'record_function', refuse)
    first, second = profiling.span('a'), profiling.span('b')
    with first as inside:
      with second:
        pass
  assert first is second and inside is None
  with profiling.recording() as record:
    pass
  with profiling.span('after'):
    pass
  assert record.spans == [] and profiling._recording is None


def test_spans_nest_with_parents_and_one_call_id_per_root():
  with profiling.recording() as record:
    with profiling.span('root'):
      with profiling.span('a'):
        with profiling.span('a.inner'):
          pass
      with profiling.recording() as again:
        assert again is record
        with profiling.span('b'):
          pass
    with profiling.span('second'):
      with profiling.span('c'):
        pass
  assert profiling._recording is None
  got = [(s.name, s.id, s.parent, s.call) for s in record.spans]
  assert got == [('root', 1, None, 1), ('a', 2, 1, 1), ('a.inner', 3, 2, 1),
                 ('b', 4, 1, 1), ('second', 5, None, 5), ('c', 6, 5, 5)]
  for s in record.spans:
    assert s.end_ns >= s.start_ns
    if s.parent is not None:
      parent = record.spans[s.parent - 1]
      assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
  assert [c.name for c in record.children(record.spans[0])] == ['a', 'b']
  # No CUDA here: the spans carry no device interval.
  assert all(record.device_ms(s) is None for s in record.spans)


def test_self_time_is_the_duration_less_the_childrens():
  record = profiling.Recording(profiling.Anchor(0, 0, 0))
  record.spans = [profiling.Span('root', 1, None, 1, 100, 200),
                  profiling.Span('a', 2, 1, 1, 110, 140),
                  profiling.Span('a.inner', 3, 2, 1, 115, 135),
                  profiling.Span('b', 4, 1, 1, 150, 190)]
  assert [record.self_ns(s) for s in record.spans] == [30, 10, 20, 40]
  with profiling.recording() as measured:
    with profiling.span('root'):
      with profiling.span('child'):
        time.sleep(0.002)
  root, child = measured.spans
  assert measured.self_ns(root) == root.duration_ns - child.duration_ns
  assert child.duration_ns >= 2_000_000 > measured.self_ns(root) >= 0


def test_a_span_closes_when_an_exception_passes():
  with pytest.raises(ValueError):
    with profiling.recording() as record:
      with profiling.span('outer'):
        with profiling.span('inner'):
          raise ValueError('through both spans')
  assert profiling._recording is None
  assert record.open_spans == []
  outer, inner = record.spans
  assert inner.parent == outer.id
  assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_the_anchor_holds_three_clocks_read_together():
  before = (time.time_ns(), time.monotonic_ns(), time.perf_counter_ns())
  with profiling.recording() as record:
    pass
  after = (time.time_ns(), time.monotonic_ns(), time.perf_counter_ns())
  anchor = record.anchor
  readings = (anchor.time_ns, anchor.monotonic_ns, anchor.perf_counter_ns)
  for low, reading, high in zip(before, readings, after):
    assert low <= reading <= high
  for clock, reading in zip(('time_ns', 'monotonic_ns', 'perf_counter_ns'),
                            readings):
    assert anchor.on(clock, anchor.perf_counter_ns + 5) == reading + 5


def test_a_recorded_decode_is_the_six_span_tree_and_decodes_the_same():
  model = gnat.GNATModel(gnat.GNATConfig(**SMALL), device='cpu')
  params = model.init(torch.Generator().manual_seed(3))
  frames = torch.randn((3, 9, SMALL['feature_size']),
                       generator=torch.Generator().manual_seed(4))
  num_frames = torch.tensor([9, 5, 1])
  plain = model.decode(params, frames, num_frames)
  with profiling.recording() as record:
    recorded = model.decode(params, frames, num_frames)
  names = {s.id: s.name for s in record.spans}
  assert [(s.name, names.get(s.parent)) for s in record.spans] == DECODE_TREE
  assert {s.call for s in record.spans} == {1}
  for a, b in zip(plain, recorded):
    assert torch.equal(a, b)
