"""backtrace_ms.decode: ``viterbi.backtrace`` alone, a per-frame host loop
of gathers, on the Viterbi forward's tables of the cell's first pooled
batch: the host clock over repeated calls, each ending in a synchronize,
until half a second has passed, per call. Moves decode_frames_per_s."""

from portbench.harness import port, staged, trace


def read(ctx):
  from last_torch_tpu_torch.ops import viterbi
  session, config = ctx.session, ctx.cell.config
  batch = session.pool[0]
  pf, pc, head, is_pad, wf, _, _ = staged.lattice_inputs(session, batch,
                                                         session.params)
  kw = dict(max_expansions=config['max_expansions'], frame_dependent=False)
  normalize = 'hat' if config['locally_normalized'] else 'none'
  tables = viterbi.viterbi_forward(
      pf, pc, wf, is_pad, compute_dtype=port.head_dtype(config, ctx.device),
      normalize=normalize, **kw)
  return trace.host_ms(lambda: viterbi.backtrace(*tables, is_pad, **kw))
