"""Runs one cell of the benchmark once and prints its result line.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, the benchmark's
folder and the port ``last_torch_tpu_torch``, on a machine with as many
CUDA cards as the cell asks for. It prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, the numbers of the correctness
comparison beside their limits, which also end standard error. It exits
non-zero and prints no result without the cards, without the port, or when
a module of JAX or of the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cache_dirs():
  """Every build and kernel cache inside the checkout, at fixed paths."""
  base = ROOT / '.portbench_cache'
  os.environ['TORCH_EXTENSIONS_DIR'] = str(base / 'torch_extensions')
  os.environ['TRITON_CACHE_DIR'] = str(base / 'triton')
  os.environ['CUDA_CACHE_PATH'] = str(base / 'cuda')


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  cache_dirs()
  sys.path.insert(0, str(ROOT))
  from portbench.harness import core, spec
  cell = spec.load_cell(args.workload, ROOT)

  import torch
  if not torch.cuda.is_available():
    print('no CUDA device is available', file=sys.stderr)
    return 3
  if torch.cuda.device_count() < cell.chips:
    print(f'{cell.name} needs {cell.chips} cards, '
          f'{torch.cuda.device_count()} are present', file=sys.stderr)
    return 3
  try:
    import last_torch_tpu_torch
  except ImportError as e:
    print(f'the port last_torch_tpu_torch is not in this checkout: {e}',
          file=sys.stderr)
    return 3
  port_dir = pathlib.Path(last_torch_tpu_torch.__file__).resolve().parent
  if port_dir.parent != ROOT:
    print(f'the port was imported from {port_dir}, outside the checkout',
          file=sys.stderr)
    return 3
  result, numbers, notes = core.run(cell, args.seed, args.seconds,
                                    bool(args.trace), torch.device('cuda'),
                                    STARTED)
  found = core.forbidden_modules()
  if found:
    print(f'modules of JAX or the JAX package are loaded: {found}',
          file=sys.stderr)
    return 4
  core.report(result, numbers, notes)
  return 0


if __name__ == '__main__':
  sys.exit(main())
