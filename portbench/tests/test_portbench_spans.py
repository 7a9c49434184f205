"""The program's spans on the device trace's clock (``harness/spans.py``):
placement on each of the three host clocks, idle gaps put down to the
innermost span, the readers without device activity, and on the card the
five spans under ``gnat.decode`` against the call's device interval."""

import copy
import types

import pytest
import torch

from last_torch_tpu_torch.utils import profiling
from portbench.harness import core, spans, spec
from portbench.tests import tiny

READERS = ('encoder_ms.decode', 'backtrace_device_ms.decode',
           'host_held_ms.decode')
# The three clocks far apart, so that only one of them fits.
ANCHOR = profiling.Anchor(time_ns=1_700_000_000_000_000_000,
                          monotonic_ns=4_000_000_000_000,
                          perf_counter_ns=9_000_000_000_000)
# (name, id, parent, start ns, end ns) on perf_counter_ns.
P0 = ANCHOR.perf_counter_ns
CALL = [('gnat.decode', 1, None, P0 + 1_000_000, P0 + 9_000_000),
        ('encoder.apply', 2, 1, P0 + 1_100_000, P0 + 3_000_000),
        ('viterbi.forward', 3, 1, P0 + 3_100_000, P0 + 8_000_000)]
END_NS = P0 + 9_500_000


def on_clock(index, ns):
  return spans.clocks(ANCHOR, ns)[index] / 1e3


@pytest.mark.parametrize('index', range(3))
def test_spans_are_placed_on_the_clock_the_activities_use(index):
  activities = [(on_clock(index, P0 + 1_200_000),
                 on_clock(index, P0 + 2_900_000), 'encoder_kernel'),
                (on_clock(index, P0 + 3_200_000),
                 on_clock(index, P0 + 9_400_000), 'viterbi_kernel')]
  found, placed = spans.place(CALL, ANCHOR, END_NS, activities)
  assert found == index
  for _, sid, _, start, end in CALL:
    assert placed[sid] == (on_clock(index, start), on_clock(index, end))
  # The device outlasts the host's call; the synchronize after it ends last.
  assert (placed[1][0] < activities[0][0] < placed[1][1] <
          activities[-1][1] < on_clock(index, END_NS))


def test_activities_on_no_clock_leave_the_spans_unplaced():
  far = on_clock(1, P0) + 3.6e9  # an hour past the call on every clock
  assert spans.place(CALL, ANCHOR, END_NS,
                     [(far, far + 10, 'kernel')]) == (None, {})


def test_gaps_go_to_the_innermost_open_span_and_outside_ones_are_left():
  tree = [('root', 1, None, 0, 0), ('a', 2, 1, 0, 0), ('a.inner', 3, 2, 0, 0),
          ('b', 4, 1, 0, 0)]
  placed = {1: (0.0, 100.0), 2: (10.0, 40.0), 3: (20.0, 30.0),
            4: (50.0, 90.0)}
  activities = [(0.0, 15.0, 'k'), (25.0, 40.0, 'k'), (35.0, 55.0, 'k'),
                (95.0, 120.0, 'k')]
  gaps = spans.idle_gaps(activities, 0.0, 130.0)
  assert gaps == [(15.0, 25.0), (55.0, 95.0), (120.0, 130.0)]
  total, per_gap = spans.attribute(gaps, tree, placed)
  assert total == {'a': 5.0, 'a.inner': 5.0, 'b': 35.0, 'root': 5.0}
  assert per_gap[2] == (120.0, 130.0, {})
  assert spans.depths(tree) == {1: 0, 2: 1, 3: 2, 4: 1}


def test_kernels_go_to_the_innermost_span_on_the_device():
  tree = [('root', 1, None, 0, 0), ('a', 2, 1, 0, 0), ('b', 3, 1, 0, 0)]
  # Device ms from the reference event; the activities' clock is 5000 us on.
  device = {1: (0.0, 10.0), 2: (1.0, 4.0), 3: (4.0, 9.9)}
  activities = [(5600.0, 5800.0, 'copy'), (6000.0, 8000.0, 'gemm'),
                (9000.0, 14000.0, 'scan'), (14700.0, 14800.0, 'stack'),
                (14950.0, 15000.0, 'tail')]
  placed = spans.device_on_clock(device, 1, activities)
  assert placed == {1: (5000.0, 15000.0), 2: (6000.0, 9000.0),
                    3: (9000.0, 14900.0)}
  assert spans.kernels_by_span(placed, tree, activities) == {
      'a': [('gemm', 0.002)], 'b': [('scan', 0.005), ('stack', 0.0001)],
      'root': [('copy', 0.0002), ('tail', 5e-05)]}


def reader_context(profile, device):
  cell = tiny.cell('gn_decode_b384')
  return core.Context(cell, types.SimpleNamespace(), {}, profile, device)


@pytest.mark.parametrize('name', READERS)
def test_readers_give_none_without_device_activity(name):
  reader = spec.metric_reader(tiny.cell('gn_decode_b384'), name)
  assert reader(reader_context(None, torch.device('cpu'))) is None
  assert reader(reader_context({'spans': [(0.0, 1.0, 'k')]},
                               torch.device('cpu'))) is None


def test_a_program_without_the_recorder_gives_no_readings(monkeypatch):
  monkeypatch.delattr(profiling, 'recording')
  session = types.SimpleNamespace(pool=None)
  assert spans.read_call(session) is None


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU: the spans time the CUDA kernels')


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['gn_decode_b384', 'hat_decode_b384'])
def test_the_five_spans_fill_the_calls_device_interval(card, name):
  cell = copy.deepcopy(spec.load_cell(name, tiny.ROOT))
  # Large enough that the host's lead before the first kernel, which the
  # encoder's span holds and the activities do not (~0.5-1.5 ms), stays
  # well inside 2% of the call.
  cell.traffic.update(batch=64, pool=1, max_frames=800, warmup_batches=1)
  cell.traffic['lengths'].update(low=400, high=800)
  device = torch.device('cuda')
  session = spec.driver(cell).setup(cell, 2**31 + 17, device)
  found = spans.recorded(core.Context(cell, session, {}, {'spans': True},
                                      device))
  children = ('encoder.apply', 'lattice.cache', 'viterbi.project',
              'viterbi.forward', 'viterbi.backtrace')
  assert set(found['device_ms']) == {'gnat.decode', *children}
  total = sum(found['device_ms'][n] for n in children)
  assert abs(total - found['call_device_ms']) <= 0.02 * found[
      'call_device_ms']
  assert found['clock'] in spans.CLOCKS and found['held_us'] is not None
  assert session.calls == []
