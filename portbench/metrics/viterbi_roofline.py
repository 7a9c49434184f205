"""viterbi_roofline: the Viterbi forward kernel's share of its
roofline. The least time of its work (one head product a real frame-row,
``counting.head_product_flops``, in bfloat16; each input read and output
written once), over the device time of one ``viterbi_forward`` call on the
decode's staged inputs of the cell's first pooled batch, at the cell's
normalization, by CUDA events after a warm-up. Moves
decode_frames_per_s."""

from portbench.harness import counting, port, staged, trace


def read(ctx):
  from last_torch_tpu_torch.ops import viterbi
  session, config = ctx.session, ctx.cell.config
  batch = session.pool[0]
  pf, pc, head, is_pad, wf, _, _ = staged.lattice_inputs(session, batch,
                                                         session.params)
  dtype = port.head_dtype(config, ctx.device)
  normalize = 'hat' if config['locally_normalized'] else 'none'
  forward = lambda: viterbi.viterbi_forward(
      pf, pc, wf, is_pad, max_expansions=config['max_expansions'],
      frame_dependent=False, compute_dtype=dtype, normalize=normalize)
  ms = trace.event_ms(forward)
  out = forward()
  rows = int((~is_pad).sum())
  flops = counting.head_product_flops(rows, pc.shape[0], pc.shape[1],
                                      head['vocab_w'].shape[1])
  traffic = counting.nbytes(pf, pc, is_pad, *head.values(), *out)
  least_ms, _ = counting.bound(flops, traffic, str(dtype)[6:])
  return 100.0 * least_ms / ms
